"""The protobuf wire format, in Python: the port's stand-in for
``google.protobuf``'s ``descriptor_pool``/``message_factory``/``json_format``
(which ``gofr_tpu/grpcx/runtime.py:29-31`` uses and the card's machine does
not have).

:func:`parse_descriptor_set` reads a serialized ``FileDescriptorSet`` (the
``descriptor.proto`` field numbers the ``.binpb`` files use) into
:class:`FileDesc` records that keep each file's original bytes, so reflection
serves them unchanged. :func:`load_messages` builds one message class a type,
nested types included. A message class offers what the framework's code
calls on protobuf's: keyword construction, attribute access with proto3
defaults, ``SerializeToString``/``FromString``/``MergeFromString``,
``CopyFrom``/``MergeFrom``, ``HasField``/``WhichOneof``/``SetInParent``,
repeated fields with ``add``/``append``/``extend``, maps, equality, and
:meth:`Message.to_dict` with ``MessageToDict``'s rules.

Presence is proto3's: a scalar has none (zero is not written), a
sub-message is present once assigned, once one of its fields (or a field of
a field) is set, or once a repeated field of it is added to, as protobuf's
``msg.sub.x = 1`` makes ``sub`` present; a ``oneof`` member is present when
set, even to its zero value, and setting one clears the others. Unknown
fields are skipped on parse.
"""

from __future__ import annotations

import base64
import math
import struct
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

# FieldDescriptorProto.Type
TYPE_DOUBLE, TYPE_FLOAT, TYPE_INT64, TYPE_UINT64, TYPE_INT32 = 1, 2, 3, 4, 5
TYPE_FIXED64, TYPE_FIXED32, TYPE_BOOL, TYPE_STRING, TYPE_GROUP = 6, 7, 8, 9, 10
TYPE_MESSAGE, TYPE_BYTES, TYPE_UINT32, TYPE_ENUM, TYPE_SFIXED32 = 11, 12, 13, 14, 15
TYPE_SFIXED64, TYPE_SINT32, TYPE_SINT64 = 16, 17, 18
LABEL_REPEATED = 3

WT_VARINT, WT_I64, WT_LEN, WT_SGROUP, WT_EGROUP, WT_I32 = 0, 1, 2, 3, 4, 5

_VARINT_TYPES = {TYPE_INT64, TYPE_UINT64, TYPE_INT32, TYPE_BOOL, TYPE_UINT32,
                 TYPE_ENUM, TYPE_SINT32, TYPE_SINT64}
_I64_TYPES = {TYPE_DOUBLE, TYPE_FIXED64, TYPE_SFIXED64}
_I32_TYPES = {TYPE_FLOAT, TYPE_FIXED32, TYPE_SFIXED32}
_INT_TYPES = {TYPE_INT64, TYPE_UINT64, TYPE_INT32, TYPE_UINT32, TYPE_FIXED64,
              TYPE_FIXED32, TYPE_SFIXED32, TYPE_SFIXED64, TYPE_SINT32, TYPE_SINT64}
_64BIT_INTS = {TYPE_INT64, TYPE_UINT64, TYPE_FIXED64, TYPE_SFIXED64, TYPE_SINT64}
_INT_RANGE = {
    TYPE_INT32: (-(1 << 31), (1 << 31) - 1), TYPE_SINT32: (-(1 << 31), (1 << 31) - 1),
    TYPE_SFIXED32: (-(1 << 31), (1 << 31) - 1), TYPE_UINT32: (0, (1 << 32) - 1),
    TYPE_FIXED32: (0, (1 << 32) - 1), TYPE_INT64: (-(1 << 63), (1 << 63) - 1),
    TYPE_SINT64: (-(1 << 63), (1 << 63) - 1), TYPE_SFIXED64: (-(1 << 63), (1 << 63) - 1),
    TYPE_UINT64: (0, (1 << 64) - 1), TYPE_FIXED64: (0, (1 << 64) - 1),
}


class DecodeError(ValueError):
    """Malformed protobuf bytes."""


# -- varints and raw fields ---------------------------------------------------

def encode_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def iter_fields(data: bytes) -> Iterator[tuple[int, int, Any]]:
    """(field number, wire type, value) over one message's bytes: an int for
    varint/fixed fields, a ``bytes`` slice for length-delimited ones."""
    pos, end = 0, len(data)
    while pos < end:
        key, pos = decode_varint(data, pos)
        number, wt = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wt == WT_VARINT:
            value, pos = decode_varint(data, pos)
        elif wt == WT_I64:
            if pos + 8 > end:
                raise DecodeError("truncated fixed64")
            value = int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        elif wt == WT_I32:
            if pos + 4 > end:
                raise DecodeError("truncated fixed32")
            value = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        elif wt == WT_LEN:
            n, pos = decode_varint(data, pos)
            if pos + n > end:
                raise DecodeError("truncated length-delimited field")
            value = data[pos:pos + n]
            pos += n
        elif wt == WT_SGROUP:
            pos = _skip_group(data, pos, number)
            continue
        else:
            raise DecodeError(f"bad wire type {wt}")
        yield number, wt, value


def _skip_group(data: bytes, pos: int, number: int) -> int:
    while True:
        key, pos = decode_varint(data, pos)
        wt = key & 7
        if wt == WT_EGROUP:
            if key >> 3 != number:
                raise DecodeError("mismatched end group")
            return pos
        if wt == WT_VARINT:
            _, pos = decode_varint(data, pos)
        elif wt == WT_I64:
            pos += 8
        elif wt == WT_I32:
            pos += 4
        elif wt == WT_LEN:
            n, pos = decode_varint(data, pos)
            pos += n
        elif wt == WT_SGROUP:
            pos = _skip_group(data, pos, key >> 3)
        else:
            raise DecodeError(f"bad wire type {wt}")
        if pos > len(data):
            raise DecodeError("truncated group")


def _key(number: int, wt: int) -> bytes:
    return encode_varint((number << 3) | wt)


# -- descriptors --------------------------------------------------------------

@dataclass
class FieldDesc:
    name: str
    number: int
    type: int
    repeated: bool = False
    type_name: str = ""  # fully qualified, no leading dot
    json_name: str = ""
    oneof: str | None = None
    proto3_optional: bool = False
    packed: bool | None = None  # None: proto3's default (packed scalars)
    message: "MessageDesc | None" = None  # resolved for messages and maps
    enum: "EnumDesc | None" = None

    @property
    def is_map(self) -> bool:
        return self.message is not None and self.message.map_entry

    @property
    def has_presence(self) -> bool:
        return (not self.repeated) and (
            self.type == TYPE_MESSAGE or self.oneof is not None or self.proto3_optional
        )


@dataclass
class MessageDesc:
    full_name: str
    name: str
    fields: list[FieldDesc] = field(default_factory=list)
    nested: list["MessageDesc"] = field(default_factory=list)
    enums: list["EnumDesc"] = field(default_factory=list)
    oneofs: list[str] = field(default_factory=list)
    map_entry: bool = False
    file: str = ""

    def __post_init__(self) -> None:
        self.by_name: dict[str, FieldDesc] = {}
        self.by_number: dict[int, FieldDesc] = {}

    def index(self) -> None:
        self.fields.sort(key=lambda f: f.number)
        self.by_name = {f.name: f for f in self.fields}
        self.by_number = {f.number: f for f in self.fields}


@dataclass
class EnumDesc:
    full_name: str
    values: dict[int, str] = field(default_factory=dict)  # number → name


@dataclass
class MethodDesc:
    name: str
    input_type: str
    output_type: str
    client_streaming: bool = False
    server_streaming: bool = False


@dataclass
class ServiceDesc:
    full_name: str
    name: str
    methods: list[MethodDesc] = field(default_factory=list)


@dataclass
class FileDesc:
    name: str
    package: str
    raw: bytes  # the FileDescriptorProto's bytes exactly as the set held them
    dependencies: list[str] = field(default_factory=list)
    messages: list[MessageDesc] = field(default_factory=list)
    enums: list[EnumDesc] = field(default_factory=list)
    services: list[ServiceDesc] = field(default_factory=list)
    syntax: str = "proto2"

    def all_messages(self) -> list[MessageDesc]:
        out: list[MessageDesc] = []

        def walk(ms: list[MessageDesc]) -> None:
            for m in ms:
                out.append(m)
                walk(m.nested)

        walk(self.messages)
        return out

    def all_enums(self) -> list[EnumDesc]:
        return list(self.enums) + [e for m in self.all_messages() for e in m.enums]


def _s(v: bytes) -> str:
    return bytes(v).decode("utf-8")


def _parse_enum(data: bytes, prefix: str) -> EnumDesc:
    name, values = "", {}
    for num, _wt, v in iter_fields(data):
        if num == 1:
            name = _s(v)
        elif num == 2:
            vname, vnum = "", 0
            for n2, _w2, v2 in iter_fields(v):
                if n2 == 1:
                    vname = _s(v2)
                elif n2 == 2:
                    vnum = _signed32(v2)
            values.setdefault(vnum, vname)
    return EnumDesc(f"{prefix}.{name}" if prefix else name, values)


def _parse_field(data: bytes) -> tuple[FieldDesc, int | None]:
    f = FieldDesc(name="", number=0, type=0)
    oneof_index = None
    for num, _wt, v in iter_fields(data):
        if num == 1:
            f.name = _s(v)
        elif num == 3:
            f.number = v
        elif num == 4:
            f.repeated = v == LABEL_REPEATED
        elif num == 5:
            f.type = v
        elif num == 6:
            f.type_name = _s(v).lstrip(".")
        elif num == 9:
            oneof_index = v
        elif num == 10:
            f.json_name = _s(v)
        elif num == 17:
            f.proto3_optional = bool(v)
        elif num == 8:
            for n2, _w2, v2 in iter_fields(v):
                if n2 == 2:
                    f.packed = bool(v2)
    return f, oneof_index


def _parse_message(data: bytes, prefix: str, fname: str) -> MessageDesc:
    raw_fields: list[bytes] = []
    name = ""
    m = MessageDesc(full_name="", name="", file=fname)
    nested_raw: list[bytes] = []
    enum_raw: list[bytes] = []
    for num, _wt, v in iter_fields(data):
        if num == 1:
            name = _s(v)
        elif num == 2:
            raw_fields.append(v)
        elif num == 3:
            nested_raw.append(v)
        elif num == 4:
            enum_raw.append(v)
        elif num == 8:
            for n2, _w2, v2 in iter_fields(v):
                if n2 == 1:
                    m.oneofs.append(_s(v2))
        elif num == 7:
            for n2, _w2, v2 in iter_fields(v):
                if n2 == 7:
                    m.map_entry = bool(v2)
    m.name = name
    m.full_name = f"{prefix}.{name}" if prefix else name
    for raw in raw_fields:
        f, oneof_index = _parse_field(raw)
        # a proto3 optional field's synthetic oneof is not a real one
        if oneof_index is not None and not f.proto3_optional:
            f.oneof = m.oneofs[oneof_index]
        if not f.json_name:
            f.json_name = _camel(f.name)
        m.fields.append(f)
    m.nested = [_parse_message(r, m.full_name, fname) for r in nested_raw]
    m.enums = [_parse_enum(r, m.full_name) for r in enum_raw]
    m.index()
    return m


def _camel(name: str) -> str:
    out, up = [], False
    for ch in name:
        if ch == "_":
            up = True
        elif up:
            out.append(ch.upper())
            up = False
        else:
            out.append(ch)
    return "".join(out)


def _parse_service(data: bytes, package: str) -> ServiceDesc:
    svc = ServiceDesc(full_name="", name="")
    for num, _wt, v in iter_fields(data):
        if num == 1:
            svc.name = _s(v)
        elif num == 2:
            md = MethodDesc(name="", input_type="", output_type="")
            for n2, _w2, v2 in iter_fields(v):
                if n2 == 1:
                    md.name = _s(v2)
                elif n2 == 2:
                    md.input_type = _s(v2).lstrip(".")
                elif n2 == 3:
                    md.output_type = _s(v2).lstrip(".")
                elif n2 == 5:
                    md.client_streaming = bool(v2)
                elif n2 == 6:
                    md.server_streaming = bool(v2)
            svc.methods.append(md)
    svc.full_name = f"{package}.{svc.name}" if package else svc.name
    return svc


def parse_file(raw: bytes) -> FileDesc:
    fd = FileDesc(name="", package="", raw=bytes(raw))
    msgs, enums, svcs = [], [], []
    for num, _wt, v in iter_fields(raw):
        if num == 1:
            fd.name = _s(v)
        elif num == 2:
            fd.package = _s(v)
        elif num == 3:
            fd.dependencies.append(_s(v))
        elif num == 4:
            msgs.append(v)
        elif num == 5:
            enums.append(v)
        elif num == 6:
            svcs.append(v)
        elif num == 12:
            fd.syntax = _s(v)
    fd.messages = [_parse_message(r, fd.package, fd.name) for r in msgs]
    fd.enums = [_parse_enum(r, fd.package) for r in enums]
    fd.services = [_parse_service(r, fd.package) for r in svcs]
    return fd


def parse_descriptor_set(data: bytes) -> list[FileDesc]:
    """A serialized ``FileDescriptorSet`` → its files, types resolved across
    the whole set. Raises :class:`DecodeError` on bytes that are not one."""
    files = [parse_file(v) for num, wt, v in iter_fields(bytes(data))
             if num == 1 and wt == WT_LEN]
    _resolve(files)
    return files


def _resolve(files: list[FileDesc]) -> None:
    messages = {m.full_name: m for fd in files for m in fd.all_messages()}
    enums = {e.full_name: e for fd in files for e in fd.all_enums()}
    for fd in files:
        proto3 = fd.syntax == "proto3"
        for m in fd.all_messages():
            for f in m.fields:
                if f.type == TYPE_MESSAGE:
                    f.message = messages.get(f.type_name)
                    if f.message is None:
                        raise DecodeError(f"unresolved message type {f.type_name}")
                elif f.type == TYPE_ENUM:
                    f.enum = enums.get(f.type_name)
                    if f.enum is None:
                        raise DecodeError(f"unresolved enum type {f.type_name}")
                if f.packed is None:
                    f.packed = proto3 and f.repeated and f.type in (
                        _VARINT_TYPES | _I64_TYPES | _I32_TYPES)


# -- values -------------------------------------------------------------------

def _signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _signed64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v & (1 << 63) else v


def _f32(value: float) -> float:
    return struct.unpack("<f", struct.pack("<f", value))[0]


def _default(f: FieldDesc) -> Any:
    t = f.type
    if t in (TYPE_DOUBLE, TYPE_FLOAT):
        return 0.0
    if t == TYPE_BOOL:
        return False
    if t == TYPE_STRING:
        return ""
    if t == TYPE_BYTES:
        return b""
    return 0


def _check(f: FieldDesc, value: Any) -> Any:
    """Type-check and normalize a scalar assigned to ``f``, as protobuf's
    setters do (a float field holds the float32 value)."""
    t = f.type
    if t == TYPE_STRING:
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{f.name}: expected str, got {type(value).__name__}")
        return value
    if t == TYPE_BYTES:
        if isinstance(value, str):
            value = value.encode("utf-8")
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"{f.name}: expected bytes, got {type(value).__name__}")
        return bytes(value)
    if t == TYPE_BOOL:
        if not isinstance(value, (bool, int)):
            raise TypeError(f"{f.name}: expected bool, got {type(value).__name__}")
        return bool(value)
    if t in (TYPE_DOUBLE, TYPE_FLOAT):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{f.name}: expected float, got {type(value).__name__}")
        return _f32(float(value)) if t == TYPE_FLOAT else float(value)
    if t == TYPE_ENUM:
        if isinstance(value, str):
            for num, name in f.enum.values.items():
                if name == value:
                    return num
            raise ValueError(f"{f.name}: unknown enum value {value!r}")
        if isinstance(value, bool) or not isinstance(value, int):
            raise TypeError(f"{f.name}: expected int, got {type(value).__name__}")
        return _signed32(value)
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(f"{f.name}: expected int, got {type(value).__name__}")
    lo, hi = _INT_RANGE[t]
    if not lo <= value <= hi:
        raise ValueError(f"{f.name}: value {value} out of range")
    return value


def _encode_scalar(f: FieldDesc, value: Any) -> tuple[int, bytes]:
    t = f.type
    if t in (TYPE_INT32, TYPE_INT64, TYPE_UINT32, TYPE_UINT64, TYPE_ENUM):
        return WT_VARINT, encode_varint(value)
    if t == TYPE_BOOL:
        return WT_VARINT, b"\x01" if value else b"\x00"
    if t in (TYPE_SINT32, TYPE_SINT64):
        bits = 32 if t == TYPE_SINT32 else 64
        return WT_VARINT, encode_varint((value << 1) ^ (value >> (bits - 1)))
    if t == TYPE_DOUBLE:
        return WT_I64, struct.pack("<d", value)
    if t == TYPE_FLOAT:
        return WT_I32, struct.pack("<f", value)
    if t in (TYPE_FIXED64, TYPE_SFIXED64):
        return WT_I64, (value & ((1 << 64) - 1)).to_bytes(8, "little")
    if t in (TYPE_FIXED32, TYPE_SFIXED32):
        return WT_I32, (value & 0xFFFFFFFF).to_bytes(4, "little")
    if t == TYPE_STRING:
        b = value.encode("utf-8")
        return WT_LEN, encode_varint(len(b)) + b
    if t == TYPE_BYTES:
        return WT_LEN, encode_varint(len(value)) + value
    raise TypeError(f"not a scalar type: {t}")


def _decode_scalar(f: FieldDesc, wt: int, raw: Any) -> Any:
    t = f.type
    if t == TYPE_STRING:
        return bytes(raw).decode("utf-8")
    if t == TYPE_BYTES:
        return bytes(raw)
    if t == TYPE_BOOL:
        return bool(raw)
    if t in (TYPE_INT32, TYPE_ENUM):
        return _signed32(raw)
    if t == TYPE_INT64:
        return _signed64(raw)
    if t == TYPE_UINT32:
        return raw & 0xFFFFFFFF
    if t == TYPE_UINT64:
        return raw
    if t == TYPE_SINT32:
        raw &= 0xFFFFFFFF
        return (raw >> 1) ^ -(raw & 1)
    if t == TYPE_SINT64:
        return (raw >> 1) ^ -(raw & 1)
    if t == TYPE_DOUBLE:
        return struct.unpack("<d", raw.to_bytes(8, "little"))[0]
    if t == TYPE_FLOAT:
        return struct.unpack("<f", raw.to_bytes(4, "little"))[0]
    if t == TYPE_FIXED64:
        return raw
    if t == TYPE_FIXED32:
        return raw
    if t == TYPE_SFIXED64:
        return _signed64(raw)
    if t == TYPE_SFIXED32:
        return _signed32(raw)
    raise DecodeError(f"not a scalar type: {t}")


def _expected_wt(t: int) -> int:
    if t in _I64_TYPES:
        return WT_I64
    if t in _I32_TYPES:
        return WT_I32
    if t in (TYPE_STRING, TYPE_BYTES, TYPE_MESSAGE):
        return WT_LEN
    return WT_VARINT


def _unpack(f: FieldDesc, data: bytes) -> list[Any]:
    out, pos, end = [], 0, len(data)
    wt = _expected_wt(f.type)
    while pos < end:
        if wt == WT_VARINT:
            raw, pos = decode_varint(data, pos)
        elif wt == WT_I64:
            raw = int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        else:
            raw = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if pos > end:
            raise DecodeError("truncated packed field")
        out.append(_decode_scalar(f, wt, raw))
    return out


# -- containers ---------------------------------------------------------------

class RepeatedScalar(list):
    """A repeated scalar field: a list whose writes are type-checked and make
    the owning message present."""

    def __init__(self, owner: "Message", fdesc: FieldDesc, items: Iterable = ()) -> None:
        super().__init__(_check(fdesc, v) for v in items)
        self._owner, self._f = owner, fdesc

    def append(self, value: Any) -> None:
        super().append(_check(self._f, value))
        self._owner._touch()

    def extend(self, values: Iterable) -> None:
        super().extend(_check(self._f, v) for v in values)
        self._owner._touch()

    def insert(self, i: int, value: Any) -> None:
        super().insert(i, _check(self._f, value))
        self._owner._touch()

    def __setitem__(self, i: Any, value: Any) -> None:
        if isinstance(i, slice):
            value = [_check(self._f, v) for v in value]
        else:
            value = _check(self._f, value)
        super().__setitem__(i, value)
        self._owner._touch()


class RepeatedComposite(list):
    """A repeated message field: ``add(**fields)``, ``append(msg)`` (a copy),
    ``extend(msgs)``."""

    def __init__(self, owner: "Message", fdesc: FieldDesc) -> None:
        super().__init__()
        self._owner, self._f = owner, fdesc

    def _cls(self) -> type:
        return self._owner._classes[self._f.type_name]

    def add(self, **kwargs: Any) -> "Message":
        msg = self._cls()(**kwargs)
        super().append(msg)
        self._owner._touch()
        return msg

    def append(self, msg: Any) -> None:
        cls = self._cls()
        if isinstance(msg, dict):
            msg = cls(**msg)
        elif not isinstance(msg, cls):
            raise TypeError(f"{self._f.name}: expected {cls.__name__}, got "
                            f"{type(msg).__name__}")
        else:
            copy = cls()
            copy.CopyFrom(msg)
            msg = copy
        super().append(msg)
        self._owner._touch()

    def extend(self, msgs: Iterable) -> None:
        for m in msgs:
            self.append(m)


class MessageMap(dict):
    """A ``map<,>`` field: keys and values checked; a message-valued map
    creates the entry on first ``m[key]``, as protobuf's does."""

    def __init__(self, owner: "Message", fdesc: FieldDesc) -> None:
        super().__init__()
        self._owner = owner
        self._kf = fdesc.message.by_number[1]
        self._vf = fdesc.message.by_number[2]

    def __setitem__(self, key: Any, value: Any) -> None:
        if self._vf.type == TYPE_MESSAGE:
            raise ValueError("assign fields of a message-valued map entry, not the entry")
        super().__setitem__(_check(self._kf, key), _check(self._vf, value))
        self._owner._touch()

    def __getitem__(self, key: Any) -> Any:
        key = _check(self._kf, key)
        if self._vf.type == TYPE_MESSAGE and key not in self:
            super().__setitem__(key, self._owner._classes[self._vf.type_name]())
            self._owner._touch()
        return super().__getitem__(key)

    def update(self, other: Any = (), **kw: Any) -> None:
        items = other.items() if hasattr(other, "items") else other
        for k, v in list(items) + list(kw.items()):
            if self._vf.type == TYPE_MESSAGE:
                self[k].CopyFrom(v)
            else:
                self[k] = v

    def _set_raw(self, key: Any, value: Any) -> None:
        super().__setitem__(key, value)


# -- messages -----------------------------------------------------------------

class Message:
    """Base of every generated message class. Subclasses carry
    ``DESCRIPTOR`` (a :class:`MessageDesc`) and ``_classes`` (full name →
    class for the whole set)."""

    DESCRIPTOR: MessageDesc
    _classes: dict[str, type]
    __slots__ = ("_values", "_parent")

    def __init__(self, **kwargs: Any) -> None:
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_parent", None)
        for name, value in kwargs.items():
            f = self.DESCRIPTOR.by_name.get(name)
            if f is None:
                raise ValueError(f"{type(self).__name__} has no field {name!r}")
            if value is None:
                continue
            if f.is_map:
                getattr(self, name).update(value)
            elif f.repeated:
                getattr(self, name).extend(value)
            elif f.type == TYPE_MESSAGE:
                sub = getattr(self, name)
                if isinstance(value, dict):
                    value = self._classes[f.type_name](**value)
                sub.CopyFrom(value)
            else:
                setattr(self, name, value)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        f = type(self).DESCRIPTOR.by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        values = self._values
        if name in values:
            return values[name]
        if f.is_map:
            values[name] = MessageMap(self, f)
            return values[name]
        if f.repeated:
            values[name] = (RepeatedComposite(self, f) if f.type == TYPE_MESSAGE
                            else RepeatedScalar(self, f))
            return values[name]
        if f.type == TYPE_MESSAGE:
            # a default sub-message that joins its parent once written to
            sub = self._classes[f.type_name]()
            object.__setattr__(sub, "_parent", (self, name))
            return sub
        return _default(f)

    def __setattr__(self, name: str, value: Any) -> None:
        f = type(self).DESCRIPTOR.by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.repeated or f.type == TYPE_MESSAGE:
            raise AttributeError(
                f"assignment to the {'repeated' if f.repeated else 'message'} field "
                f"{name!r} is not allowed: use CopyFrom/extend/add")
        value = _check(f, value)
        if f.oneof is not None:
            self._clear_oneof(f.oneof, keep=name)
        self._values[name] = value
        self._touch()

    def _clear_oneof(self, oneof: str, keep: str) -> None:
        for other in self.DESCRIPTOR.fields:
            if other.oneof == oneof and other.name != keep:
                self._values.pop(other.name, None)

    def _touch(self) -> None:
        """Make this message present in its parent (and the parent in its
        own), as a write to a default sub-message does in protobuf."""
        parent = self._parent
        if parent is None:
            return
        owner, name = parent
        object.__setattr__(self, "_parent", None)
        f = owner.DESCRIPTOR.by_name[name]
        if f.oneof is not None:
            owner._clear_oneof(f.oneof, keep=name)
        current = owner._values.get(name)
        if current is None:
            owner._values[name] = self
        elif current is not self:
            current.MergeFrom(self)
        owner._touch()

    # -- protobuf's message API ---------------------------------------------
    def HasField(self, name: str) -> bool:
        f = self.DESCRIPTOR.by_name.get(name)
        if f is None:
            if name in self.DESCRIPTOR.oneofs:
                return self.WhichOneof(name) is not None
            raise ValueError(f"{type(self).__name__} has no field {name!r}")
        if not f.has_presence:
            raise ValueError(f"field {name!r} has no presence")
        return name in self._values

    def WhichOneof(self, oneof: str) -> str | None:
        if oneof not in self.DESCRIPTOR.oneofs:
            raise ValueError(f"{type(self).__name__} has no oneof {oneof!r}")
        for f in self.DESCRIPTOR.fields:
            if f.oneof == oneof and f.name in self._values:
                return f.name
        return None

    def SetInParent(self) -> None:
        self._touch()

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        if type(other).DESCRIPTOR.full_name != self.DESCRIPTOR.full_name:
            raise TypeError(f"CopyFrom: {type(other).__name__} is not "
                            f"{type(self).__name__}")
        self._values.clear()
        self.MergeFromString(other.SerializeToString())
        self._touch()

    def MergeFrom(self, other: "Message") -> None:
        self.MergeFromString(other.SerializeToString())
        self._touch()

    def _written(self, f: FieldDesc) -> bool:
        """Whether ``f`` goes on the wire: present for a field with
        presence, non-empty for a repeated one, non-zero for a scalar."""
        if f.name not in self._values:
            return False
        v = self._values[f.name]
        if f.repeated:
            return len(v) > 0
        if f.has_presence:
            return True
        if f.type in (TYPE_FLOAT, TYPE_DOUBLE):
            return v != 0.0 or math.copysign(1.0, v) < 0
        return bool(v)

    # -- wire ---------------------------------------------------------------
    def SerializeToString(self, deterministic: bool = False) -> bytes:
        out = bytearray()
        for f in self.DESCRIPTOR.fields:
            if not self._written(f):
                continue
            v = self._values[f.name]
            if f.is_map:
                kf, vf = f.message.by_number[1], f.message.by_number[2]
                items = sorted(v.items()) if deterministic else v.items()
                for k, val in items:
                    # an entry carries its key and value even at their
                    # defaults, as protobuf writes them
                    wt, b = _encode_scalar(kf, k)
                    entry = bytearray(_key(1, wt) + b)
                    if vf.type == TYPE_MESSAGE:
                        sub = val.SerializeToString(deterministic)
                        entry += _key(2, WT_LEN) + encode_varint(len(sub)) + sub
                    else:
                        wt, b = _encode_scalar(vf, val)
                        entry += _key(2, wt) + b
                    out += _key(f.number, WT_LEN) + encode_varint(len(entry)) + entry
            elif f.type == TYPE_MESSAGE:
                for sub in (v if f.repeated else (v,)):
                    b = sub.SerializeToString(deterministic)
                    out += _key(f.number, WT_LEN) + encode_varint(len(b)) + b
            elif f.repeated and f.packed:
                body = b"".join(_encode_scalar(f, x)[1] for x in v)
                out += _key(f.number, WT_LEN) + encode_varint(len(body)) + body
            elif f.repeated:
                for x in v:
                    wt, b = _encode_scalar(f, x)
                    out += _key(f.number, wt) + b
            else:
                wt, b = _encode_scalar(f, v)
                out += _key(f.number, wt) + b
        return bytes(out)

    def MergeFromString(self, data: bytes) -> int:
        data = bytes(data)
        by_number = self.DESCRIPTOR.by_number
        values = self._values
        for number, wt, raw in iter_fields(data):
            f = by_number.get(number)
            if f is None:
                continue  # unknown field: skipped
            if f.is_map:
                k = v = None
                kf, vf = f.message.by_number[1], f.message.by_number[2]
                for n2, w2, r2 in iter_fields(raw):
                    if n2 == 1 and w2 == _expected_wt(kf.type):
                        k = _decode_scalar(kf, w2, r2)
                    elif n2 == 2 and w2 == _expected_wt(vf.type):
                        if vf.type == TYPE_MESSAGE:
                            v = self._classes[vf.type_name].FromString(r2)
                        else:
                            v = _decode_scalar(vf, w2, r2)
                if k is None:
                    k = _default(kf)
                if v is None:
                    v = (self._classes[vf.type_name]() if vf.type == TYPE_MESSAGE
                         else _default(vf))
                getattr(self, f.name)._set_raw(k, v)
            elif f.type == TYPE_MESSAGE:
                if wt != WT_LEN:
                    raise DecodeError(f"{f.name}: wrong wire type {wt}")
                if f.repeated:
                    lst = getattr(self, f.name)
                    list.append(lst, self._classes[f.type_name].FromString(raw))
                else:
                    sub = values.get(f.name)
                    if sub is None:
                        sub = self._classes[f.type_name]()
                        if f.oneof is not None:
                            self._clear_oneof(f.oneof, keep=f.name)
                        values[f.name] = sub
                    sub.MergeFromString(raw)
            elif f.repeated:
                lst = getattr(self, f.name)
                if wt == WT_LEN and f.type not in (TYPE_STRING, TYPE_BYTES):
                    list.extend(lst, _unpack(f, raw))
                elif wt == _expected_wt(f.type):
                    list.append(lst, _decode_scalar(f, wt, raw))
                else:
                    raise DecodeError(f"{f.name}: wrong wire type {wt}")
            else:
                if wt != _expected_wt(f.type):
                    raise DecodeError(f"{f.name}: wrong wire type {wt}")
                if f.oneof is not None:
                    self._clear_oneof(f.oneof, keep=f.name)
                values[f.name] = _decode_scalar(f, wt, raw)
        return len(data)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        msg.MergeFromString(data)
        return msg

    # -- views --------------------------------------------------------------
    def to_dict(self, preserving_proto_field_name: bool = False) -> dict[str, Any]:
        """``json_format.MessageToDict``'s rules: fields at their default
        omitted, 64-bit integers as strings, bytes as base64, enums by
        name, floats as the shortest repr that reads back the same."""
        out: dict[str, Any] = {}
        for f in self.DESCRIPTOR.fields:
            if not self._written(f):
                continue
            key = f.name if preserving_proto_field_name else f.json_name
            v = self._values[f.name]
            if f.is_map:
                kf, vf = f.message.by_number[1], f.message.by_number[2]
                out[key] = {_map_key_json(kf, k): _json_value(vf, x, preserving_proto_field_name)
                            for k, x in v.items()}
            elif f.repeated:
                out[key] = [_json_value(f, x, preserving_proto_field_name) for x in v]
            else:
                out[key] = _json_value(f, v, preserving_proto_field_name)
        return out

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Message):
            return NotImplemented
        if type(other).DESCRIPTOR.full_name != self.DESCRIPTOR.full_name:
            return False
        return _canonical(self) == _canonical(other)

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_dict(True)!r})"


def _canonical(msg: Message) -> Any:
    out = []
    for f in msg.DESCRIPTOR.fields:
        if not msg._written(f):
            continue
        v = msg._values[f.name]
        if f.is_map:
            vf = f.message.by_number[2]
            v = sorted((k, _canonical(x) if vf.type == TYPE_MESSAGE else x)
                       for k, x in v.items())
        elif f.type == TYPE_MESSAGE:
            v = [_canonical(x) for x in v] if f.repeated else _canonical(v)
        elif f.repeated:
            v = list(v)
        out.append((f.number, v))
    return out


def _short_float(value: float) -> float:
    """``json_format``'s float32 rendering: the fewest digits that read back
    as the same float32."""
    if math.isnan(value) or math.isinf(value):
        return value
    precision = 6
    rounded = float(f"{value:.{precision}g}")
    while _f32(rounded) != value:
        precision += 1
        rounded = float(f"{value:.{precision}g}")
    return rounded


def _json_value(f: FieldDesc, v: Any, preserve: bool) -> Any:
    t = f.type
    if t == TYPE_MESSAGE:
        return v.to_dict(preserve)
    if t in _64BIT_INTS:
        return str(v)
    if t == TYPE_BYTES:
        return base64.b64encode(v).decode("ascii")
    if t == TYPE_ENUM:
        return f.enum.values.get(v, v)
    if t in (TYPE_FLOAT, TYPE_DOUBLE):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return _short_float(v) if t == TYPE_FLOAT else v
    return v


def _map_key_json(kf: FieldDesc, k: Any) -> str:
    if kf.type == TYPE_BOOL:
        return "true" if k else "false"
    return str(k)


# -- classes from a descriptor set -------------------------------------------

def message_classes(files: list[FileDesc]) -> dict[str, type]:
    """One class per message type of ``files`` (nested ones included),
    keyed by full name; every class sees the whole table."""
    classes: dict[str, type] = {}
    for fd in files:
        for m in fd.all_messages():
            classes[m.full_name] = type(m.name, (Message,), {
                "__slots__": (), "DESCRIPTOR": m, "_classes": classes,
                "__qualname__": m.name, "__module__": __name__,
            })
    return classes


def load_messages(fds_bytes: bytes) -> dict[str, type]:
    """Message classes for every type in a serialized FileDescriptorSet
    (``gofr_tpu/grpcx/runtime.py:39-57``); each call builds its own
    classes, so generated modules never share state."""
    return message_classes(parse_descriptor_set(fds_bytes))
