"""MySQL client/server wire protocol subset (protocol 4.1).

Reference parity: sql.go:212-237 registers the mysql dialect through
go-sql-driver/mysql; this image has no MySQL client library or network,
so — like pg_wire — the published protocol is implemented directly:

- packet framing: 3-byte little-endian length + sequence id
- HandshakeV10 greeting / HandshakeResponse41 with
  ``mysql_native_password`` scrambling
  (``SHA1(pass) XOR SHA1(nonce + SHA1(SHA1(pass)))``)
- OK (0x00) / ERR (0xff) / EOF (0xfe) packets
- COM_QUERY text resultsets (column count, column definitions, rows of
  length-encoded strings, NULL = 0xfb), COM_PING, COM_QUIT

Parameters are client-side interpolated with full escaping (the
go-sql-driver ``interpolateParams`` model) — the text protocol carries
no placeholders, and COM_STMT_PREPARE is out of subset.

The port's copy of ``gofr_tpu/datasource/sql/mysql_wire.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any

CLIENT_LONG_PASSWORD = 0x00000001
CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_DEPRECATE_EOF = 0x01000000

COM_QUIT = 0x01
COM_QUERY = 0x03
COM_PING = 0x0E

NATIVE_PLUGIN = b"mysql_native_password"


class MySQLError(ConnectionError):
    def __init__(self, code: int, sqlstate: str, message: str) -> None:
        self.code = code
        self.sqlstate = sqlstate
        super().__init__(f"({code}, {sqlstate}): {message}")


# ---------------------------------------------------------------- packets
def send_packet(sock: Any, seq: int, payload: bytes) -> int:
    """Write one packet; returns the next sequence id. Payloads at the
    16 MB framing limit need continuation packets (out of subset) — fail
    loudly instead of silently truncating the 3-byte length and
    desyncing the protocol."""
    if len(payload) >= 0xFFFFFF:
        raise MySQLError(
            2020, "HY000",
            f"packet of {len(payload)} bytes exceeds the 16MB framing limit",
        )
    sock.sendall(struct.pack("<I", len(payload))[:3] + bytes([seq & 0xFF]) + payload)
    return (seq + 1) & 0xFF


class PacketReader:
    """Buffered packet reader over a socket."""

    def __init__(self, sock: Any) -> None:
        self.sock = sock
        self._buf = b""

    def _fill(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise MySQLError(2013, "HY000", "lost connection during read")
            self._buf += chunk

    def read_packet(self) -> tuple[int, bytes]:
        self._fill(4)
        length = int.from_bytes(self._buf[:3], "little")
        seq = self._buf[3]
        self._fill(4 + length)
        payload = self._buf[4 : 4 + length]
        self._buf = self._buf[4 + length :]
        return seq, payload


# ---------------------------------------------------------------- lenenc
def lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def read_lenenc_int(data: bytes, pos: int) -> tuple[int, int]:
    first = data[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(data[pos + 1 : pos + 4], "little"), pos + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9
    raise MySQLError(2027, "HY000", f"malformed length-encoded int 0x{first:02x}")


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def read_lenenc_str(data: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = read_lenenc_int(data, pos)
    return data[pos : pos + n], pos + n


# ---------------------------------------------------------------- auth
def native_password_scramble(password: str, nonce: bytes) -> bytes:
    """``SHA1(pass) XOR SHA1(nonce + SHA1(SHA1(pass)))`` (empty password
    sends an empty auth response)."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def handshake_v10(server_version: str, thread_id: int, nonce: bytes,
                  capabilities: int) -> bytes:
    """Server greeting (nonce is the full 20-byte auth-plugin-data)."""
    assert len(nonce) == 20
    out = bytes([10]) + server_version.encode() + b"\x00"
    out += struct.pack("<I", thread_id)
    out += nonce[:8] + b"\x00"
    out += struct.pack("<H", capabilities & 0xFFFF)
    out += bytes([0x21])  # charset utf8_general_ci
    out += struct.pack("<H", 0x0002)  # status: autocommit
    out += struct.pack("<H", (capabilities >> 16) & 0xFFFF)
    out += bytes([21])  # auth-plugin-data length
    out += b"\x00" * 10
    out += nonce[8:20] + b"\x00"
    out += NATIVE_PLUGIN + b"\x00"
    return out


def parse_handshake_v10(payload: bytes) -> dict[str, Any]:
    if payload[0] != 10:
        raise MySQLError(2012, "HY000", f"unsupported protocol {payload[0]}")
    end = payload.index(b"\x00", 1)
    version = payload[1:end].decode()
    pos = end + 1
    thread_id = struct.unpack_from("<I", payload, pos)[0]
    pos += 4
    nonce = payload[pos : pos + 8]
    pos += 9  # 8 bytes + filler
    cap_low = struct.unpack_from("<H", payload, pos)[0]
    pos += 2
    charset = payload[pos]
    pos += 1
    status = struct.unpack_from("<H", payload, pos)[0]
    pos += 2
    cap_high = struct.unpack_from("<H", payload, pos)[0]
    pos += 2
    auth_len = payload[pos]
    pos += 1 + 10  # length byte + reserved
    capabilities = cap_low | (cap_high << 16)
    if capabilities & CLIENT_SECURE_CONNECTION:
        # part 2 is 12 scramble bytes + a single NUL terminator; take
        # exactly 12 rather than rstrip-ing ALL trailing NULs — a scramble
        # legitimately ending in 0x00 must not be truncated (it would
        # corrupt the 20-byte nonce and fail mysql_native_password auth)
        extra = max(13, auth_len - 8)
        part2 = payload[pos : pos + extra]
        nonce += part2[:12] if len(part2) >= 13 else part2.rstrip(b"\x00")
        pos += extra
    plugin = b""
    if capabilities & CLIENT_PLUGIN_AUTH:
        nul = payload.find(b"\x00", pos)
        plugin = payload[pos:nul] if nul >= 0 else payload[pos:]
    return {
        "version": version,
        "thread_id": thread_id,
        "nonce": nonce[:20],
        "capabilities": capabilities,
        "charset": charset,
        "status": status,
        "plugin": plugin.decode() if plugin else "",
    }


def handshake_response_41(user: str, password: str, database: str,
                          nonce: bytes) -> bytes:
    caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
            | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH)
    if database:
        caps |= CLIENT_CONNECT_WITH_DB
    auth = native_password_scramble(password, nonce)
    out = struct.pack("<IIB", caps, 1 << 24, 0x21) + b"\x00" * 23
    out += user.encode() + b"\x00"
    out += bytes([len(auth)]) + auth
    if database:
        out += database.encode() + b"\x00"
    out += NATIVE_PLUGIN + b"\x00"
    return out


def parse_handshake_response(payload: bytes) -> dict[str, Any]:
    caps, max_packet, charset = struct.unpack_from("<IIB", payload, 0)
    pos = 9 + 23
    nul = payload.index(b"\x00", pos)
    user = payload[pos:nul].decode()
    pos = nul + 1
    auth_len = payload[pos]
    pos += 1
    auth = payload[pos : pos + auth_len]
    pos += auth_len
    database = ""
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(payload):
        nul = payload.find(b"\x00", pos)
        if nul >= 0:
            database = payload[pos:nul].decode()
            pos = nul + 1
    return {"capabilities": caps, "user": user, "auth": auth, "database": database}


# ---------------------------------------------------------------- replies
def ok_packet(affected: int = 0, last_insert_id: int = 0,
              warnings: int = 0) -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
            + struct.pack("<HH", 0x0002, warnings))


def err_packet(code: int, sqlstate: str, message: str) -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + sqlstate.encode()[:5]
            + message.encode())


def eof_packet(warnings: int = 0, status: int = 0x0002) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def parse_ok(payload: bytes) -> dict[str, int]:
    affected, pos = read_lenenc_int(payload, 1)
    last_id, pos = read_lenenc_int(payload, pos)
    status, warnings = struct.unpack_from("<HH", payload, pos)
    return {"affected_rows": affected, "last_insert_id": last_id,
            "status": status, "warnings": warnings}


def parse_err(payload: bytes) -> MySQLError:
    code = struct.unpack_from("<H", payload, 1)[0]
    pos = 3
    sqlstate = "HY000"
    if pos < len(payload) and payload[pos : pos + 1] == b"#":
        sqlstate = payload[pos + 1 : pos + 6].decode()
        pos += 6
    return MySQLError(code, sqlstate, payload[pos:].decode("utf-8", "replace"))


def column_definition(name: str, type_code: int = 0xFD) -> bytes:
    """Column definition 4.1 (type 0xfd = VAR_STRING by default)."""
    out = lenenc_str(b"def") + lenenc_str(b"") + lenenc_str(b"")
    out += lenenc_str(b"") + lenenc_str(name.encode()) + lenenc_str(b"")
    out += bytes([0x0C]) + struct.pack("<H", 0x21) + struct.pack("<I", 1024)
    out += bytes([type_code]) + struct.pack("<H", 0) + bytes([0]) + b"\x00\x00"
    return out


def parse_column_definition(payload: bytes) -> str:
    pos = 0
    for _ in range(4):  # catalog, schema, table, org_table
        _, pos = read_lenenc_str(payload, pos)
    name, pos = read_lenenc_str(payload, pos)
    return name.decode()


def text_row(values: list) -> bytes:
    out = b""
    for v in values:
        if v is None:
            out += b"\xfb"
        else:
            out += lenenc_str(str(v).encode())
    return out


def parse_text_row(payload: bytes, n_cols: int) -> list[str | None]:
    out: list[str | None] = []
    pos = 0
    for _ in range(n_cols):
        if payload[pos] == 0xFB:
            out.append(None)
            pos += 1
        else:
            raw, pos = read_lenenc_str(payload, pos)
            out.append(raw.decode("utf-8", "replace"))
    return out


# ---------------------------------------------------------------- escaping
def escape_value(v: Any) -> str:
    """Client-side parameter interpolation (text protocol carries no
    placeholders) — go-sql-driver interpolateParams model."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, (bytes, bytearray)):
        hexed = bytes(v).hex()
        return f"x'{hexed}'"
    s = str(v)
    s = (s.replace("\\", "\\\\").replace("'", "''").replace("\x00", "\\0")
         .replace("\n", "\\n").replace("\r", "\\r").replace("\x1a", "\\Z"))
    return f"'{s}'"


def interpolate(sql: str, args: tuple) -> str:
    """Substitute ``?`` placeholders (outside quotes/comments) with
    escaped values."""
    if not args:
        return sql
    out: list[str] = []
    it = iter(args)
    i = 0
    in_sq = in_dq = in_line_comment = in_block_comment = False
    while i < len(sql):
        ch = sql[i]
        if in_line_comment:
            out.append(ch)
            if ch == "\n":
                in_line_comment = False
        elif in_block_comment:
            out.append(ch)
            if ch == "*" and sql[i : i + 2] == "*/":
                out.append("/")
                i += 1
                in_block_comment = False
        elif in_sq:
            out.append(ch)
            if ch == "\\" and i + 1 < len(sql):
                # MySQL interprets backslash escapes in string literals by
                # default (no NO_BACKSLASH_ESCAPES): 'O\'Brien' must not
                # flip the quote state (go-sql-driver interpolateParams)
                out.append(sql[i + 1])
                i += 1
            elif ch == "'":
                in_sq = False
        elif in_dq:
            out.append(ch)
            if ch == "\\" and i + 1 < len(sql):
                out.append(sql[i + 1])
                i += 1
            elif ch == '"':
                in_dq = False
        elif ch == "'":
            in_sq = True
            out.append(ch)
        elif ch == '"':
            in_dq = True
            out.append(ch)
        elif ch == "-" and sql[i : i + 2] == "--":
            in_line_comment = True
            out.append(ch)
        elif ch == "#":  # MySQL line comment
            in_line_comment = True
            out.append(ch)
        elif ch == "/" and sql[i : i + 2] == "/*":
            # consume BOTH opener chars: '/*/' must not read its '*' as
            # the start of the terminator (code-review r4)
            in_block_comment = True
            out.append("/*")
            i += 1
        elif ch == "?":
            try:
                out.append(escape_value(next(it)))
            except StopIteration:
                raise MySQLError(2057, "HY000", "not enough parameters") from None
        else:
            out.append(ch)
        i += 1
    return "".join(out)
