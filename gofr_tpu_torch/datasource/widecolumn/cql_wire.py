"""From-scratch CQL binary protocol v4 codec (Cassandra/Scylla wire).

Built from the public native_protocol_v4.spec the way mysql_wire/
postgres_wire were built from their protocol docs. Frame layout:

    version(1) flags(1) stream(2, signed BE) opcode(1) length(4)

Opcodes: ERROR/STARTUP/READY/QUERY/RESULT/BATCH cover the reference's
Cassandra interface (container/datasources.go:42-194 — Query/Exec/
ExecCAS + logged/unlogged batches). Values travel interpolated into the
statement text (the repo's MySQL-dialect recipe) so the unprepared QUERY
path needs no type negotiation; RESULT rows come back fully typed via
the column-spec metadata this module also decodes.

The port's copy of ``gofr_tpu/datasource/widecolumn/cql_wire.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Any

VERSION_REQUEST = 0x04
VERSION_RESPONSE = 0x84

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_BATCH = 0x0D

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003

CONSISTENCY_ONE = 0x0001
CONSISTENCY_QUORUM = 0x0004

LOGGED_BATCH = 0
UNLOGGED_BATCH = 1
COUNTER_BATCH = 2

# CQL option ids (type codes in column specs)
TYPE_CUSTOM = 0x0000
TYPE_BIGINT = 0x0002
TYPE_BLOB = 0x0003
TYPE_BOOLEAN = 0x0004
TYPE_DOUBLE = 0x0007
TYPE_INT = 0x0009
TYPE_VARCHAR = 0x000D


class CQLError(RuntimeError):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


# ---------------------------------------------------------------- primitives
def string(s: str) -> bytes:
    raw = s.encode()
    return struct.pack(">H", len(raw)) + raw


def long_string(s: str) -> bytes:
    raw = s.encode()
    return struct.pack(">i", len(raw)) + raw


def string_map(m: dict[str, str]) -> bytes:
    out = struct.pack(">H", len(m))
    for k, v in m.items():
        out += string(k) + string(v)
    return out


def read_string(data: bytes, pos: int) -> tuple[str, int]:
    (n,) = struct.unpack_from(">H", data, pos)
    pos += 2
    return data[pos : pos + n].decode(), pos + n


def read_long_string(data: bytes, pos: int) -> tuple[str, int]:
    (n,) = struct.unpack_from(">i", data, pos)
    pos += 4
    return data[pos : pos + n].decode(), pos + n


def read_string_map(data: bytes, pos: int) -> tuple[dict[str, str], int]:
    (n,) = struct.unpack_from(">H", data, pos)
    pos += 2
    out = {}
    for _ in range(n):
        k, pos = read_string(data, pos)
        v, pos = read_string(data, pos)
        out[k] = v
    return out, pos


def read_bytes(data: bytes, pos: int) -> tuple[bytes | None, int]:
    (n,) = struct.unpack_from(">i", data, pos)
    pos += 4
    if n < 0:
        return None, pos
    return data[pos : pos + n], pos + n


def write_bytes(raw: bytes | None) -> bytes:
    if raw is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(raw)) + raw


# ---------------------------------------------------------------- framing
def encode_frame(stream: int, opcode: int, body: bytes = b"",
                 *, response: bool = False) -> bytes:
    version = VERSION_RESPONSE if response else VERSION_REQUEST
    return struct.pack(">BBhBi", version, 0, stream, opcode, len(body)) + body


def parse_frame_header(head: bytes) -> tuple[int, int, int, int]:
    """(version, stream, opcode, body_length)"""
    version, _flags, stream, opcode, length = struct.unpack(">BBhBi", head)
    return version, stream, opcode, length


# ---------------------------------------------------------------- requests
def encode_startup(stream: int = 0) -> bytes:
    return encode_frame(
        stream, OP_STARTUP, string_map({"CQL_VERSION": "3.0.0"})
    )


def encode_query(stream: int, query: str,
                 consistency: int = CONSISTENCY_ONE) -> bytes:
    body = long_string(query) + struct.pack(">HB", consistency, 0)
    return encode_frame(stream, OP_QUERY, body)


def encode_batch(stream: int, batch_type: int, queries: list[str],
                 consistency: int = CONSISTENCY_ONE) -> bytes:
    body = struct.pack(">BH", batch_type, len(queries))
    for q in queries:
        # kind 0 = query string, then n(values)=0
        body += b"\x00" + long_string(q) + struct.pack(">H", 0)
    body += struct.pack(">HB", consistency, 0)
    return encode_frame(stream, OP_BATCH, body)


def decode_batch(body: bytes) -> tuple[int, list[str]]:
    batch_type = body[0]
    (n,) = struct.unpack_from(">H", body, 1)
    pos = 3
    queries = []
    for _ in range(n):
        kind = body[pos]
        pos += 1
        if kind != 0:
            raise CQLError(0x000A, "only kind-0 (query string) supported")
        q, pos = read_long_string(body, pos)
        (nvals,) = struct.unpack_from(">H", body, pos)
        pos += 2
        for _ in range(nvals):
            _, pos = read_bytes(body, pos)
        queries.append(q)
    return batch_type, queries


# ---------------------------------------------------------------- values
def type_of(value: Any) -> int:
    if isinstance(value, bool):
        return TYPE_BOOLEAN
    if isinstance(value, int):
        return TYPE_BIGINT
    if isinstance(value, float):
        return TYPE_DOUBLE
    if isinstance(value, (bytes, bytearray)):
        return TYPE_BLOB
    return TYPE_VARCHAR


def encode_value(value: Any) -> bytes | None:
    if value is None:
        return None
    if isinstance(value, bool):
        return b"\x01" if value else b"\x00"
    if isinstance(value, int):
        return struct.pack(">q", value)
    if isinstance(value, float):
        return struct.pack(">d", value)
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    return str(value).encode()


def decode_value(type_id: int, raw: bytes | None) -> Any:
    if raw is None:
        return None
    if type_id == TYPE_BOOLEAN:
        return raw != b"\x00"
    if type_id == TYPE_BIGINT:
        return struct.unpack(">q", raw)[0]
    if type_id == TYPE_INT:
        return struct.unpack(">i", raw)[0]
    if type_id == TYPE_DOUBLE:
        return struct.unpack(">d", raw)[0]
    if type_id == TYPE_BLOB:
        return raw
    return raw.decode()


def escape_literal(value: Any) -> str:
    """CQL literal for client-side interpolation (single quotes double;
    CQL has no backslash escapes — unlike MySQL)."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (bytes, bytearray)):
        return "0x" + bytes(value).hex()
    s = str(value).replace("'", "''")
    return f"'{s}'"


def interpolate(stmt: str, values: tuple) -> str:
    """Substitute ``?`` placeholders outside string literals/comments."""
    if not values:
        return stmt
    out: list[str] = []
    it = iter(values)
    in_sq = False
    i = 0
    while i < len(stmt):
        ch = stmt[i]
        if in_sq:
            out.append(ch)
            if ch == "'":
                # '' is an escaped quote inside the literal
                if i + 1 < len(stmt) and stmt[i + 1] == "'":
                    out.append("'")
                    i += 1
                else:
                    in_sq = False
        elif ch == "'":
            in_sq = True
            out.append(ch)
        elif ch == "?":
            try:
                out.append(escape_literal(next(it)))
            except StopIteration:
                raise CQLError(
                    0x2200, "more ? placeholders than values"
                ) from None
        else:
            out.append(ch)
        i += 1
    rest = list(it)
    if rest:
        raise CQLError(0x2200, f"{len(rest)} unused query values")
    return "".join(out)


# ---------------------------------------------------------------- results
def encode_rows(rows: list[dict[str, Any]],
                columns: list[tuple[str, int]] | None = None,
                keyspace: str = "ks", table: str = "t") -> bytes:
    """RESULT body, kind=Rows: global-table-spec metadata + typed rows."""
    if columns is None:
        # infer specs from the row dicts: first-seen key order, type from
        # the first non-null value (varchar when a column is all null)
        names: list[str] = []
        types: dict[str, int | None] = {}
        for row in rows:
            for key, value in row.items():
                if key not in types:
                    names.append(key)
                    types[key] = None
                if types[key] is None and value is not None:
                    types[key] = type_of(value)
        columns = [(k, types[k] if types[k] is not None else TYPE_VARCHAR)
                   for k in names]
    body = struct.pack(">i", RESULT_ROWS)
    body += struct.pack(">ii", 0x0001, len(columns))  # global_tables_spec
    body += string(keyspace) + string(table)
    for name, type_id in columns:
        body += string(name) + struct.pack(">H", type_id)
    body += struct.pack(">i", len(rows))
    for row in rows:
        for name, type_id in columns:
            body += write_bytes(encode_value(row.get(name)))
    return body


def decode_result(body: bytes) -> tuple[int, list[dict[str, Any]]]:
    """(kind, rows) — rows non-empty only for kind=Rows."""
    (kind,) = struct.unpack_from(">i", body, 0)
    if kind != RESULT_ROWS:
        return kind, []
    flags, col_count = struct.unpack_from(">ii", body, 4)
    pos = 12
    if flags & 0x0001:  # global_tables_spec
        _, pos = read_string(body, pos)
        _, pos = read_string(body, pos)
    columns: list[tuple[str, int]] = []
    for _ in range(col_count):
        if not flags & 0x0001:
            _, pos = read_string(body, pos)
            _, pos = read_string(body, pos)
        name, pos = read_string(body, pos)
        (type_id,) = struct.unpack_from(">H", body, pos)
        pos += 2
        if type_id == TYPE_CUSTOM:
            _, pos = read_string(body, pos)
        columns.append((name, type_id))
    (row_count,) = struct.unpack_from(">i", body, pos)
    pos += 4
    rows = []
    for _ in range(row_count):
        row = {}
        for name, type_id in columns:
            raw, pos = read_bytes(body, pos)
            row[name] = decode_value(type_id, raw)
        rows.append(row)
    return kind, rows


def encode_error(code: int, message: str) -> bytes:
    return struct.pack(">i", code) + string(message)


def decode_error(body: bytes) -> CQLError:
    (code,) = struct.unpack_from(">i", body, 0)
    message, _ = read_string(body, 4)
    return CQLError(code, message)
