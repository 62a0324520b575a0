"""From-scratch BSON codec (the subset the Mongo wire driver speaks).

Implemented per the public BSON spec (bsonspec.org): double, string,
embedded document, array, binary, ObjectId, boolean, UTC datetime, null,
int32, int64. That covers every shape the reference's Mongo interface
moves (container/datasources.go:232-300 — filters, documents, update
specs, command replies).

No third-party bson dependency: like the repo's Postgres/MySQL/AMQP/SSH
stacks, the wire bytes are produced here so the driver and the testutil
server share one audited codec (golden vectors in
tests/test_torch_golden_frames.py pin the spec examples).

The port's copy of ``gofr_tpu/datasource/document/bson.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import os
import struct
import threading
import time
from typing import Any

_COUNTER_LOCK = threading.Lock()
_COUNTER = int.from_bytes(os.urandom(3), "big")
_MACHINE = os.urandom(5)


class Binary(bytes):
    """bytes with a BSON binary subtype (e.g. 4 = UUID — required for
    ``lsid.id``; real servers reject subtype-0 session ids)."""

    subtype: int = 0

    def __new__(cls, data: bytes, subtype: int = 0) -> "Binary":
        self = super().__new__(cls, data)
        self.subtype = subtype
        return self


class Int64(int):
    """int pinned to BSON int64 — commands like ``txnNumber``/``getMore``
    demand the long type even for small values."""


class ObjectId:
    """12-byte Mongo object id: 4-byte seconds + 5-byte random + 3-byte
    counter (the modern driver recipe)."""

    __slots__ = ("_raw",)

    def __init__(self, value: "bytes | str | ObjectId | None" = None) -> None:
        global _COUNTER
        if value is None:
            with _COUNTER_LOCK:
                _COUNTER = (_COUNTER + 1) & 0xFFFFFF
                count = _COUNTER
            self._raw = (
                struct.pack(">I", int(time.time()))
                + _MACHINE
                + count.to_bytes(3, "big")
            )
        elif isinstance(value, ObjectId):
            self._raw = value._raw
        elif isinstance(value, bytes):
            if len(value) != 12:
                raise ValueError("ObjectId needs 12 bytes")
            self._raw = value
        elif isinstance(value, str):
            if len(value) != 24:
                raise ValueError("ObjectId hex needs 24 chars")
            self._raw = bytes.fromhex(value)
        else:
            raise TypeError(f"cannot build ObjectId from {type(value).__name__}")

    @property
    def binary(self) -> bytes:
        return self._raw

    def __str__(self) -> str:
        return self._raw.hex()

    def __repr__(self) -> str:
        return f"ObjectId({self._raw.hex()!r})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectId) and other._raw == self._raw

    def __hash__(self) -> int:
        return hash(self._raw)


def _cstring(s: str) -> bytes:
    b = s.encode()
    if b"\x00" in b:
        raise ValueError("BSON cstring cannot contain NUL")
    return b + b"\x00"


def _encode_element(name: str, value: Any) -> bytes:
    key = _cstring(name)
    if isinstance(value, bool):  # before int: bool is an int subclass
        return b"\x08" + key + (b"\x01" if value else b"\x00")
    if isinstance(value, float):
        return b"\x01" + key + struct.pack("<d", value)
    if isinstance(value, str):
        raw = value.encode()
        return b"\x02" + key + struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    if isinstance(value, dict):
        return b"\x03" + key + encode_document(value)
    if isinstance(value, (list, tuple)):
        as_doc = {str(i): v for i, v in enumerate(value)}
        return b"\x04" + key + encode_document(as_doc)
    if isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
        subtype = value.subtype if isinstance(value, Binary) else 0
        return (b"\x05" + key + struct.pack("<i", len(raw))
                + bytes([subtype]) + raw)
    if isinstance(value, ObjectId):
        return b"\x07" + key + value.binary
    if isinstance(value, _dt.datetime):
        ms = int(value.timestamp() * 1000)
        return b"\x09" + key + struct.pack("<q", ms)
    if value is None:
        return b"\x0a" + key
    if isinstance(value, Int64):
        return b"\x12" + key + struct.pack("<q", value)
    if isinstance(value, int):
        if -(2**31) <= value < 2**31:
            return b"\x10" + key + struct.pack("<i", value)
        return b"\x12" + key + struct.pack("<q", value)
    raise TypeError(f"BSON cannot encode {type(value).__name__}")


def encode_document(doc: dict) -> bytes:
    body = b"".join(_encode_element(str(k), v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _read_cstring(data: bytes, pos: int) -> tuple[str, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end].decode(), end + 1


def decode_document(data: bytes, pos: int = 0) -> tuple[dict, int]:
    """Decode one document at ``pos``; returns (doc, next offset)."""
    (length,) = struct.unpack_from("<i", data, pos)
    end = pos + length - 1  # position of the trailing NUL
    pos += 4
    out: dict = {}
    while pos < end:
        etype = data[pos]
        pos += 1
        name, pos = _read_cstring(data, pos)
        if etype == 0x01:
            (out[name],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif etype == 0x02:
            (slen,) = struct.unpack_from("<i", data, pos)
            pos += 4
            out[name] = data[pos : pos + slen - 1].decode()
            pos += slen
        elif etype == 0x03:
            out[name], pos = decode_document(data, pos)
        elif etype == 0x04:
            arr, pos = decode_document(data, pos)
            out[name] = [arr[k] for k in sorted(arr, key=int)]
        elif etype == 0x05:
            (blen,) = struct.unpack_from("<i", data, pos)
            subtype = data[pos + 4]
            pos += 5  # length + subtype byte
            raw = data[pos : pos + blen]
            out[name] = Binary(raw, subtype) if subtype else raw
            pos += blen
        elif etype == 0x07:
            out[name] = ObjectId(data[pos : pos + 12])
            pos += 12
        elif etype == 0x08:
            out[name] = data[pos] == 1
            pos += 1
        elif etype == 0x09:
            (ms,) = struct.unpack_from("<q", data, pos)
            pos += 8
            out[name] = _dt.datetime.fromtimestamp(ms / 1000, _dt.timezone.utc)
        elif etype == 0x0A:
            out[name] = None
        elif etype == 0x10:
            (out[name],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif etype == 0x12:
            (out[name],) = struct.unpack_from("<q", data, pos)
            pos += 8
        else:
            raise ValueError(f"unsupported BSON element type 0x{etype:02x}")
    return out, end + 1
