"""PostgreSQL wire protocol v3 codec (frontend + backend messages).

Reference parity: pkg/gofr/datasource/sql/sql.go:212-237 registers a
postgres dialect through database/sql + lib/pq; this image has no
Postgres client library or server, so — like the Kafka/MQTT/RESP2
drivers — the protocol is implemented from the public spec and shared by
the driver (sql/postgres.py) and the sqlite-backed test server
(testutil/postgres_server.py):

- startup: int32 len | int32 196608 | "user\\0..\\0" pairs | \\0
- regular messages: byte type | int32 len(includes itself) | payload
- auth: Ok(0), CleartextPassword(3), MD5Password(5) — md5 response is
  ``"md5" + md5(md5(password + user) + salt)``
- extended query: Parse/Bind/Describe/Execute/Sync with text-format
  parameters and results, plus the simple 'Q' path
- text-format result decoding by type OID (bool/int/float/numeric/text/
  bytea/json)

The port's copy of ``gofr_tpu/datasource/sql/pg_wire.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Any

PROTOCOL_VERSION = 196608  # 3.0

# backend message types
AUTH = b"R"
PARAM_STATUS = b"S"
BACKEND_KEY = b"K"
READY = b"Z"
ROW_DESC = b"T"
DATA_ROW = b"D"
CMD_COMPLETE = b"C"
ERROR = b"E"
NOTICE = b"N"
EMPTY_QUERY = b"I"
PARSE_COMPLETE = b"1"
BIND_COMPLETE = b"2"
CLOSE_COMPLETE = b"3"
NO_DATA = b"n"
PARAM_DESC = b"t"

# auth codes
AUTH_OK = 0
AUTH_CLEARTEXT = 3
AUTH_MD5 = 5

# type OIDs (pg_type.dat)
OID_BOOL = 16
OID_BYTEA = 17
OID_INT8 = 20
OID_INT2 = 21
OID_INT4 = 23
OID_TEXT = 25
OID_JSON = 114
OID_FLOAT4 = 700
OID_FLOAT8 = 701
OID_VARCHAR = 1043
OID_NUMERIC = 1700
OID_JSONB = 3802


class PgError(ConnectionError):
    def __init__(self, fields: dict[str, str]) -> None:
        self.fields = fields
        self.severity = fields.get("S", "ERROR")
        self.code = fields.get("C", "")
        super().__init__(f"{self.severity} {self.code}: {fields.get('M', 'unknown')}")


# ---------------------------------------------------------------- primitives
def cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def msg(mtype: bytes, payload: bytes = b"") -> bytes:
    return mtype + struct.pack(">i", len(payload) + 4) + payload


def startup_message(user: str, database: str, params: dict[str, str] | None = None) -> bytes:
    body = struct.pack(">i", PROTOCOL_VERSION)
    body += cstr("user") + cstr(user)
    body += cstr("database") + cstr(database)
    for k, v in (params or {}).items():
        body += cstr(k) + cstr(v)
    body += b"\x00"
    return struct.pack(">i", len(body) + 4) + body


def md5_password(user: str, password: str, salt: bytes) -> str:
    inner = hashlib.md5(password.encode() + user.encode()).hexdigest()
    return "md5" + hashlib.md5(inner.encode() + salt).hexdigest()


class Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise PgError({"M": "short read in message body"})
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def int8(self) -> int:
        return self.take(1)[0]

    def int16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def cstr(self) -> str:
        try:
            end = self.data.index(b"\x00", self.pos)
        except ValueError:  # malformed frame must surface as a typed PgError
            raise PgError({"M": "unterminated string in message"}) from None
        out = self.data[self.pos : end].decode()
        self.pos = end + 1
        return out

    def remaining(self) -> int:
        return len(self.data) - self.pos


def read_message(recv_exact) -> tuple[bytes, Reader]:
    """One typed backend/frontend message via ``recv_exact(n) -> bytes``."""
    mtype = recv_exact(1)
    (size,) = struct.unpack(">i", recv_exact(4))
    if size < 4 or size > 64 * 1024 * 1024:
        raise PgError({"M": f"bad message size {size}"})
    return mtype, Reader(recv_exact(size - 4))


def recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PgError({"M": "connection closed by peer"})
        buf += chunk
    return buf


# ---------------------------------------------------------------- frontend
def parse_message(stmt: str, query: str) -> bytes:
    return msg(b"P", cstr(stmt) + cstr(query) + struct.pack(">h", 0))


def bind_message(portal: str, stmt: str, params: list[Any]) -> bytes:
    body = cstr(portal) + cstr(stmt)
    body += struct.pack(">h", 0)  # all params text format
    body += struct.pack(">h", len(params))
    for p in params:
        if p is None:
            body += struct.pack(">i", -1)
        else:
            data = encode_text_param(p)
            body += struct.pack(">i", len(data)) + data
    body += struct.pack(">h", 0)  # all results text format
    return msg(b"B", body)


def describe_portal(portal: str) -> bytes:
    return msg(b"D", b"P" + cstr(portal))


def execute_message(portal: str, max_rows: int = 0) -> bytes:
    return msg(b"E", cstr(portal) + struct.pack(">i", max_rows))


def sync_message() -> bytes:
    return msg(b"S")


def query_message(sql: str) -> bytes:
    return msg(b"Q", cstr(sql))


def terminate_message() -> bytes:
    return msg(b"X")


def password_message(response: str) -> bytes:
    return msg(b"p", cstr(response))


def encode_text_param(value: Any) -> bytes:
    if isinstance(value, bool):
        return b"t" if value else b"f"
    if isinstance(value, bytes):
        return b"\\x" + value.hex().encode()
    if isinstance(value, (dict, list)):
        return json.dumps(value).encode()
    return str(value).encode()


# ---------------------------------------------------------------- backend
def error_fields(r: Reader) -> dict[str, str]:
    fields: dict[str, str] = {}
    while r.remaining() > 1:
        code = r.take(1)
        if code == b"\x00":
            break
        fields[code.decode()] = r.cstr()
    return fields


def decode_row_description(r: Reader) -> list[tuple[str, int]]:
    """→ [(column name, type oid)]."""
    n = r.int16()
    cols = []
    for _ in range(n):
        name = r.cstr()
        r.int32()  # table oid
        r.int16()  # attnum
        oid = r.int32()
        r.int16()  # type len
        r.int32()  # type mod
        r.int16()  # format code
        cols.append((name, oid))
    return cols


def decode_data_row(r: Reader, cols: list[tuple[str, int]]) -> dict[str, Any]:
    n = r.int16()
    row: dict[str, Any] = {}
    for i in range(n):
        size = r.int32()
        name, oid = cols[i] if i < len(cols) else (f"col{i}", OID_TEXT)
        if size < 0:
            row[name] = None
        else:
            row[name] = decode_text_value(r.take(size), oid)
    return row


def decode_text_value(data: bytes, oid: int) -> Any:
    text = data.decode()
    if oid == OID_BOOL:
        return text in ("t", "true", "1")
    if oid in (OID_INT2, OID_INT4, OID_INT8):
        return int(text)
    if oid in (OID_FLOAT4, OID_FLOAT8, OID_NUMERIC):
        return float(text)
    if oid == OID_BYTEA:
        return bytes.fromhex(text[2:]) if text.startswith("\\x") else data
    if oid in (OID_JSON, OID_JSONB):
        try:
            return json.loads(text)
        except ValueError:
            return text
    return text


def oid_for_python(value: Any) -> int:
    """The backend side: pick a result OID from a python value (the
    sqlite-backed test server has no catalog)."""
    if isinstance(value, bool):
        return OID_BOOL
    if isinstance(value, int):
        return OID_INT8
    if isinstance(value, float):
        return OID_FLOAT8
    if isinstance(value, bytes):
        return OID_BYTEA
    return OID_TEXT


def encode_row_description(cols: list[tuple[str, int]]) -> bytes:
    body = struct.pack(">h", len(cols))
    for name, oid in cols:
        body += cstr(name)
        body += struct.pack(">ihihih", 0, 0, oid, -1, -1, 0)
    return msg(ROW_DESC, body)


def encode_data_row(values: list[Any]) -> bytes:
    body = struct.pack(">h", len(values))
    for v in values:
        if v is None:
            body += struct.pack(">i", -1)
        else:
            data = encode_text_param(v)
            body += struct.pack(">i", len(data)) + data
    return msg(DATA_ROW, body)


def encode_error(message: str, code: str = "XX000", severity: str = "ERROR") -> bytes:
    body = b"S" + cstr(severity) + b"C" + cstr(code) + b"M" + cstr(message) + b"\x00"
    return msg(ERROR, body)


def encode_ready(status: bytes = b"I") -> bytes:
    return msg(READY, status)


def encode_auth(code: int, extra: bytes = b"") -> bytes:
    return msg(AUTH, struct.pack(">i", code) + extra)


def encode_command_complete(tag: str) -> bytes:
    return msg(CMD_COMPLETE, cstr(tag))


def encode_param_status(key: str, value: str) -> bytes:
    return msg(PARAM_STATUS, cstr(key) + cstr(value))
