"""Kafka wire-protocol codec (the subset the driver + test broker speak; a
copy of ``gofr_tpu/datasource/pubsub/kafka_wire.py``).

Reference parity: pkg/gofr/datasource/pubsub/kafka/kafka.go drives
segmentio/kafka-go; this image has no Kafka client library, so — like the
MQTT driver (mqtt.py) — the protocol is implemented directly from the
public Kafka protocol spec:

- request framing: int32 size | int16 api_key | int16 api_version |
  int32 correlation_id | nullable_string client_id | body
- response framing: int32 size | int32 correlation_id | body
- **record batch v2 (magic 2)** — the modern (Kafka ≥0.11) on-disk and
  wire format the driver produces and fetches: batch header with CRC-32C
  over the post-crc bytes, zigzag-varint records, per-record headers.
  The legacy magic-0 message set codec is retained ONLY so tests can
  craft old-format frames and assert the broker rejects them
  (UNSUPPORTED_VERSION / CORRUPT_MESSAGE — VERDICT r2 item 5).

Shared by the production driver (kafka.py) and the in-process test broker
(testutil/kafka_broker.py) — the CI-service-container pattern (SURVEY §4
tier 4) without docker.
"""

from __future__ import annotations

import struct
import time as _time
import zlib

# api keys
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2
METADATA = 3
OFFSET_COMMIT = 8
OFFSET_FETCH = 9
CREATE_TOPICS = 19
DELETE_TOPICS = 20

# error codes (subset)
NONE = 0
OFFSET_OUT_OF_RANGE = 1
CORRUPT_MESSAGE = 2
UNKNOWN_TOPIC_OR_PARTITION = 3
UNSUPPORTED_VERSION = 35
TOPIC_ALREADY_EXISTS = 36

EARLIEST_TIMESTAMP = -2
LATEST_TIMESTAMP = -1

# the api_versions the modern driver speaks (record-batch v2 era)
PRODUCE_API_VERSION = 3
FETCH_API_VERSION = 4


class KafkaError(ConnectionError):
    def __init__(self, code: int, context: str = "") -> None:
        super().__init__(f"kafka error {code}{f' ({context})' if context else ''}")
        self.code = code


# ---------------------------------------------------------------- primitives
def int8(v: int) -> bytes:
    return struct.pack(">b", v)


def int16(v: int) -> bytes:
    return struct.pack(">h", v)


def int32(v: int) -> bytes:
    return struct.pack(">i", v)


def int64(v: int) -> bytes:
    return struct.pack(">q", v)


def string(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    data = s.encode()
    return struct.pack(">h", len(data)) + data


def bytes_(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def array(items: list[bytes]) -> bytes:
    return struct.pack(">i", len(items)) + b"".join(items)


class Reader:
    """Cursor over a response/request body."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise KafkaError(-1, "short read")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def int8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def uint32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> str | None:
        n = self.int16()
        if n < 0:
            return None
        return self._take(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.int32()
        if n < 0:
            return None
        return self._take(n)

    def uvarint(self) -> int:
        shift, out = 0, 0
        while True:
            b = self._take(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise KafkaError(-1, "varint too long")

    def varint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def varint_bytes(self) -> bytes | None:
        n = self.varint()
        if n < 0:
            return None
        return self._take(n)

    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------- crc32c
def _make_crc32c_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) — the record-batch v2 checksum. zlib.crc32 is
    IEEE and silently wrong here; real brokers reject the batch."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------- varints
def uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint(v: int) -> bytes:
    """Zigzag-encoded signed varint (record fields)."""
    return uvarint((v << 1) ^ (v >> 63))


def varint_bytes(b: bytes | None) -> bytes:
    if b is None:
        return varint(-1)
    return varint(len(b)) + b


# ---------------------------------------------------------------- record batch v2
_BATCH_HEADER = struct.Struct(">qiib")  # base_offset, batch_len, leader_epoch, magic


def encode_record_batch(
    base_offset: int,
    entries: list[tuple[bytes | None, bytes, list[tuple[str, bytes]]]],
    timestamp_ms: int | None = None,
) -> bytes:
    """[(key, value, headers)] → one magic-2 RecordBatch."""
    ts = int(_time.time() * 1000) if timestamp_ms is None else timestamp_ms
    records = bytearray()
    for i, (key, value, headers) in enumerate(entries):
        body = bytearray()
        body += b"\x00"  # record attributes
        body += varint(0)  # timestamp delta
        body += varint(i)  # offset delta
        body += varint_bytes(key)
        body += varint_bytes(value)
        body += varint(len(headers))
        for hk, hv in headers:
            hkb = hk.encode()
            body += varint(len(hkb)) + hkb
            body += varint_bytes(hv)
        records += varint(len(body)) + body

    n = len(entries)
    # everything the crc covers: attributes .. records
    crc_body = (
        int16(0)  # batch attributes: no compression, create-time timestamps
        + int32(max(0, n - 1))  # last offset delta
        + int64(ts)  # base timestamp
        + int64(ts)  # max timestamp
        + int64(-1)  # producer id (no idempotence)
        + int16(-1)  # producer epoch
        + int32(-1)  # base sequence
        + int32(n)
        + bytes(records)
    )
    crc = crc32c(crc_body)
    # batch_length counts bytes after the batch_length field itself
    batch_len = 4 + 1 + 4 + len(crc_body)  # leader_epoch + magic + crc + body
    return (
        int64(base_offset)
        + int32(batch_len)
        + int32(-1)  # partition leader epoch
        + int8(2)  # magic
        + struct.pack(">I", crc)
        + crc_body
    )


def decode_record_batches(
    data: bytes,
) -> list[tuple[int, bytes | None, bytes, list[tuple[str, bytes]]]]:
    """A record-set (one or more magic-2 batches, possibly truncated at
    max_bytes) → [(offset, key, value, headers)]. Validates magic + CRC-32C.
    Raises on magic 0/1 — the modern driver must not silently accept
    legacy frames."""
    out: list[tuple[int, bytes | None, bytes, list[tuple[str, bytes]]]] = []
    r = Reader(data)
    while r.remaining() >= 17:  # batch header prefix up to magic
        base_offset = r.int64()
        batch_len = r.int32()
        if r.remaining() < batch_len:
            break  # partial trailing batch (broker truncation)
        batch = Reader(r._take(batch_len))
        batch.int32()  # partition leader epoch
        magic = batch.int8()
        if magic != 2:
            raise KafkaError(
                CORRUPT_MESSAGE, f"record batch magic {magic}, want 2"
            )
        crc = batch.uint32()
        crc_body = batch.data[batch.pos :]
        if crc32c(crc_body) != crc:
            raise KafkaError(CORRUPT_MESSAGE, f"crc32c mismatch at {base_offset}")
        batch.int16()  # attributes
        batch.int32()  # last offset delta
        batch.int64()  # base timestamp
        batch.int64()  # max timestamp
        batch.int64()  # producer id
        batch.int16()  # producer epoch
        batch.int32()  # base sequence
        n = batch.int32()
        for _ in range(n):
            length = batch.varint()
            rec = Reader(batch._take(length))
            rec.int8()  # attributes
            rec.varint()  # timestamp delta
            offset_delta = rec.varint()
            key = rec.varint_bytes()
            value = rec.varint_bytes()
            headers = []
            for _h in range(rec.varint()):
                hk = rec._take(rec.varint()).decode()
                hv = rec.varint_bytes()
                headers.append((hk, hv or b""))
            out.append((base_offset + offset_delta, key, value or b"", headers))
    return out


# ------------------------------------------------- legacy messages (magic 0)
def encode_message(key: bytes | None, value: bytes) -> bytes:
    """One magic-0 message: crc | magic | attributes | key | value."""
    body = int8(0) + int8(0) + bytes_(key) + bytes_(value)
    return struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body


def encode_message_set(
    entries: list[tuple[int, bytes | None, bytes]]
) -> bytes:
    """[(offset, key, value)] -> wire message set (no count prefix)."""
    out = bytearray()
    for offset, key, value in entries:
        msg = encode_message(key, value)
        out += int64(offset) + int32(len(msg)) + msg
    return bytes(out)


def decode_message_set(data: bytes) -> list[tuple[int, bytes | None, bytes]]:
    """Wire message set -> [(offset, key, value)]; tolerates a trailing
    partial message (the broker may truncate at max_bytes)."""
    out: list[tuple[int, bytes | None, bytes]] = []
    r = Reader(data)
    while r.remaining() >= 12:
        offset = r.int64()
        size = r.int32()
        if r.remaining() < size:
            break  # partial trailing message
        msg = Reader(r._take(size))
        crc = msg.uint32()
        payload = msg.data[msg.pos :]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise KafkaError(-1, f"crc mismatch at offset {offset}")
        msg.int8()  # magic
        msg.int8()  # attributes
        key = msg.bytes_()
        value = msg.bytes_()
        out.append((offset, key, value or b""))
    return out


# ---------------------------------------------------------------- framing
def encode_request(
    api_key: int, api_version: int, correlation_id: int, client_id: str, body: bytes
) -> bytes:
    payload = (
        int16(api_key)
        + int16(api_version)
        + int32(correlation_id)
        + string(client_id)
        + body
    )
    return int32(len(payload)) + payload


def read_frame(recv_exact) -> bytes:
    """Read one length-prefixed frame via a ``recv_exact(n) -> bytes``."""
    (size,) = struct.unpack(">i", recv_exact(4))
    if size < 0 or size > 64 * 1024 * 1024:
        raise KafkaError(-1, f"bad frame size {size}")
    return recv_exact(size)


def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes from a socket (both Kafka peers use this)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise KafkaError(-1, "connection closed by peer")
        buf += chunk
    return buf
