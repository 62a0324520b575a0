"""AMQP 1.0 wire subset — the protocol Azure Event Hubs speaks (a copy of
``gofr_tpu/datasource/pubsub/amqp_wire.py``).

Reference parity: pkg/gofr/datasource/pubsub/eventhub (787 LoC) wraps the
azeventhubs SDK; this image has no Azure SDK or network, so — like
kafka_wire / mqtt / nats / pg_wire — the driver implements the published
protocol (OASIS AMQP 1.0, ISO 19464) directly: the type system (§1.6),
frame encoding (§2.3), the connection/session/link performatives (§2.7),
message sections (§3.2), and the SASL security layer (§5.3) in the
subset Event Hubs exercises (PLAIN/ANONYMOUS auth, sender/receiver
links, transfer/disposition with accepted outcome, flow credit).

Encoding discipline: performative fields carry their spec-mandated types
via the thin wrapper classes (Uint/Ulong/Ubyte/Ushort/Symbol) so the
bytes are interoperable, not just self-consistent — golden-frame tests
(tests/test_torch_golden_frames.py) pin representative encodings against
byte-exact vectors derived from the spec.
"""

from __future__ import annotations

import struct
from typing import Any

PROTO_AMQP = b"AMQP\x00\x01\x00\x00"
PROTO_SASL = b"AMQP\x03\x01\x00\x00"

FRAME_AMQP = 0
FRAME_SASL = 1

# performative / section / outcome descriptor codes (spec §2.7, §3.2, §3.4)
OPEN = 0x10
BEGIN = 0x11
ATTACH = 0x12
FLOW = 0x13
TRANSFER = 0x14
DISPOSITION = 0x15
DETACH = 0x16
END = 0x17
CLOSE = 0x18
SOURCE = 0x28
TARGET = 0x29
HEADER = 0x70
DELIVERY_ANNOTATIONS = 0x71
MESSAGE_ANNOTATIONS = 0x72
PROPERTIES = 0x73
APPLICATION_PROPERTIES = 0x74
DATA = 0x75
ACCEPTED = 0x24
REJECTED = 0x25
RELEASED = 0x26
SASL_MECHANISMS = 0x40
SASL_INIT = 0x41
SASL_OUTCOME = 0x44


class AmqpError(ConnectionError):
    pass


# ---------------------------------------------------------------- type system
class Symbol(str):
    """AMQP symbol (ASCII token) — distinct wire constructor from string."""


class Ubyte(int):
    pass


class Ushort(int):
    pass


class Uint(int):
    pass


class Ulong(int):
    pass


class Described:
    """A described value: descriptor (ulong code) + underlying value."""

    __slots__ = ("descriptor", "value")

    def __init__(self, descriptor: int, value: Any) -> None:
        self.descriptor = descriptor
        self.value = value

    def __repr__(self) -> str:  # debugging aid only
        return f"Described(0x{self.descriptor:02x}, {self.value!r})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Described)
            and other.descriptor == self.descriptor
            and other.value == self.value
        )


def encode_value(v: Any) -> bytes:
    """Encode one AMQP value with its constructor byte (spec §1.6)."""
    if v is None:
        return b"\x40"
    if isinstance(v, Described):
        return b"\x00" + encode_value(Ulong(v.descriptor)) + encode_value(v.value)
    if isinstance(v, bool):
        return b"\x41" if v else b"\x42"
    if isinstance(v, Ubyte):
        return b"\x50" + struct.pack(">B", int(v))
    if isinstance(v, Ushort):
        return b"\x60" + struct.pack(">H", int(v))
    if isinstance(v, Uint):
        n = int(v)
        if n == 0:
            return b"\x43"
        if n < 256:
            return b"\x52" + struct.pack(">B", n)
        return b"\x70" + struct.pack(">I", n)
    if isinstance(v, Ulong):
        n = int(v)
        if n == 0:
            return b"\x44"
        if n < 256:
            return b"\x53" + struct.pack(">B", n)
        return b"\x80" + struct.pack(">Q", n)
    if isinstance(v, int):  # signed long
        if -128 <= v < 128:
            return b"\x55" + struct.pack(">b", v)
        return b"\x81" + struct.pack(">q", v)
    if isinstance(v, Symbol):
        raw = v.encode("ascii")
        if len(raw) < 256:
            return b"\xa3" + struct.pack(">B", len(raw)) + raw
        return b"\xb3" + struct.pack(">I", len(raw)) + raw
    if isinstance(v, str):
        raw = v.encode("utf-8")
        if len(raw) < 256:
            return b"\xa1" + struct.pack(">B", len(raw)) + raw
        return b"\xb1" + struct.pack(">I", len(raw)) + raw
    if isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        if len(raw) < 256:
            return b"\xa0" + struct.pack(">B", len(raw)) + raw
        return b"\xb0" + struct.pack(">I", len(raw)) + raw
    if isinstance(v, (list, tuple)):
        if not v:
            return b"\x45"  # list0
        body = b"".join(encode_value(x) for x in v)
        count = len(v)
        if len(body) + 1 < 256 and count < 256:
            return b"\xc0" + struct.pack(">BB", len(body) + 1, count) + body
        return b"\xd0" + struct.pack(">II", len(body) + 4, count) + body
    if isinstance(v, dict):
        items: list[Any] = []
        for k, val in v.items():
            items.append(k)
            items.append(val)
        body = b"".join(encode_value(x) for x in items)
        count = len(items)
        if len(body) + 1 < 256 and count < 256:
            return b"\xc1" + struct.pack(">BB", len(body) + 1, count) + body
        return b"\xd1" + struct.pack(">II", len(body) + 4, count) + body
    raise AmqpError(f"cannot encode {type(v).__name__}")


class Decoder:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise AmqpError("truncated AMQP value")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def value(self) -> Any:
        c = self.take(1)[0]
        if c == 0x00:  # described
            descriptor = self.value()
            val = self.value()
            return Described(int(descriptor), val)
        if c == 0x40:
            return None
        if c == 0x41:
            return True
        if c == 0x42:
            return False
        if c == 0x56:  # boolean with payload byte
            return self.take(1)[0] == 0x01
        if c == 0x50:
            return Ubyte(self.take(1)[0])
        if c == 0x60:
            return Ushort(struct.unpack(">H", self.take(2))[0])
        if c == 0x43:
            return Uint(0)
        if c == 0x52:
            return Uint(self.take(1)[0])
        if c == 0x70:
            return Uint(struct.unpack(">I", self.take(4))[0])
        if c == 0x44:
            return Ulong(0)
        if c == 0x53:
            return Ulong(self.take(1)[0])
        if c == 0x80:
            return Ulong(struct.unpack(">Q", self.take(8))[0])
        if c == 0x55:
            return struct.unpack(">b", self.take(1))[0]
        if c == 0x81:
            return struct.unpack(">q", self.take(8))[0]
        if c == 0x54:  # smallint
            return struct.unpack(">b", self.take(1))[0]
        if c == 0x71:  # int
            return struct.unpack(">i", self.take(4))[0]
        if c == 0xA0:
            return self.take(self.take(1)[0])
        if c == 0xB0:
            return self.take(struct.unpack(">I", self.take(4))[0])
        if c == 0xA1:
            return self.take(self.take(1)[0]).decode("utf-8")
        if c == 0xB1:
            return self.take(struct.unpack(">I", self.take(4))[0]).decode("utf-8")
        if c == 0xA3:
            return Symbol(self.take(self.take(1)[0]).decode("ascii"))
        if c == 0xB3:
            return Symbol(self.take(struct.unpack(">I", self.take(4))[0]).decode("ascii"))
        if c == 0x45:
            return []
        if c == 0xC0:
            size = self.take(1)[0]
            count = self.take(1)[0]
            return [self.value() for _ in range(count)]
        if c == 0xD0:
            size, count = struct.unpack(">II", self.take(8))
            return [self.value() for _ in range(count)]
        if c == 0xC1:
            size = self.take(1)[0]
            count = self.take(1)[0]
            vals = [self.value() for _ in range(count)]
            return dict(zip(vals[0::2], vals[1::2]))
        if c == 0xD1:
            size, count = struct.unpack(">II", self.take(8))
            vals = [self.value() for _ in range(count)]
            return dict(zip(vals[0::2], vals[1::2]))
        if c in (0xE0, 0xF0):  # array8/array32 (sasl mechanisms)
            if c == 0xE0:
                self.take(1)  # size
                count = self.take(1)[0]
            else:
                self.take(4)
                count = struct.unpack(">I", self.take(4))[0]
            ctor = self.take(1)[0]
            return [self._fixed(ctor) for _ in range(count)]
        raise AmqpError(f"unknown constructor 0x{c:02x}")

    def _fixed(self, ctor: int) -> Any:
        """Array element with a shared constructor byte."""
        if ctor == 0xA3:
            return Symbol(self.take(self.take(1)[0]).decode("ascii"))
        if ctor == 0xB3:
            return Symbol(self.take(struct.unpack(">I", self.take(4))[0]).decode("ascii"))
        if ctor == 0x71:
            return struct.unpack(">i", self.take(4))[0]
        raise AmqpError(f"unsupported array constructor 0x{ctor:02x}")


# ---------------------------------------------------------------- framing
def encode_frame(channel: int, performative: Described | None,
                 payload: bytes = b"", frame_type: int = FRAME_AMQP) -> bytes:
    body = (encode_value(performative) if performative is not None else b"") + payload
    size = 8 + len(body)
    return struct.pack(">IBBH", size, 2, frame_type, channel) + body


def decode_frame(data: bytes) -> tuple[int, int, Described | None, bytes]:
    """(channel, frame_type, performative, payload) from one whole frame."""
    if len(data) < 8:
        raise AmqpError("short frame")
    size, doff, ftype, channel = struct.unpack(">IBBH", data[:8])
    body = data[doff * 4 : size]
    if not body:
        return channel, ftype, None, b""  # empty/keepalive frame
    dec = Decoder(body)
    perf = dec.value()
    if not isinstance(perf, Described):
        raise AmqpError("frame body must start with a described performative")
    return channel, ftype, perf, body[dec.pos :]


def read_frame(recv_exact: Any) -> tuple[int, int, Described | None, bytes]:
    head = recv_exact(4)
    (size,) = struct.unpack(">I", head)
    if size < 8:
        raise AmqpError(f"invalid frame size {size}")
    rest = recv_exact(size - 4)
    return decode_frame(head + rest)


# ---------------------------------------------------------------- messages
def encode_message(body: bytes, application_properties: dict | None = None) -> bytes:
    """Bare message: optional application-properties section + one data
    section (spec §3.2) — the shape the Event Hubs SDK produces for
    EventData with properties."""
    out = b""
    if application_properties:
        out += encode_value(
            Described(APPLICATION_PROPERTIES, dict(application_properties))
        )
    out += encode_value(Described(DATA, bytes(body)))
    return out


def decode_message(payload: bytes) -> tuple[bytes, dict]:
    """(body, application_properties) — data sections concatenate, other
    sections are tolerated and skipped."""
    dec = Decoder(payload)
    body = b""
    props: dict = {}
    while dec.pos < len(payload):
        section = dec.value()
        if not isinstance(section, Described):
            continue
        if section.descriptor == DATA:
            body += section.value
        elif section.descriptor == APPLICATION_PROPERTIES and isinstance(
            section.value, dict
        ):
            props.update(section.value)
    return body, props
