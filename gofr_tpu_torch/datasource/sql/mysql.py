"""MySQL driver — protocol 4.1 over TCP (third SQL dialect).

Reference parity: sql.go:212-237 registers mysql (the DEFAULT dialect
there) via go-sql-driver; this driver speaks the wire protocol itself
(mysql_wire.py) and implements the same DB contract as sqlite.py /
postgres.py: ``query``/``query_row``/``exec``/``select``/``begin``/
``health_check`` with per-query logs + the ``app_sql_stats`` histogram
(db.go:47-66). Pooling, gauges, and the 10 s keepalive/reconnect loop
come from the shared ConnectionPool (sql.go:92-174,239-252).

Works against any 4.1 server: a real MySQL/MariaDB, or the sqlite-backed
wire server in testutil/mysql_server.py (CI service-container stand-in,
SURVEY §4 tier 4 — the reference CI runs a real MySQL on :2001,
go.yml:38-77).

The port's copy of ``gofr_tpu/datasource/sql/mysql.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import socket
from typing import Any

from gofr_tpu_torch.datasource.sql import mysql_wire as wire
from gofr_tpu_torch.datasource.sql.mysql_wire import MySQLError
from gofr_tpu_torch.datasource.sql.base import PooledSQLBase, PooledTx


class _MyConn:
    """One authenticated session. Construction runs the full handshake
    (greeting → HandshakeResponse41 with native-password scramble → OK)."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, connect_timeout: float) -> None:
        sock = socket.create_connection((host, port), timeout=connect_timeout)
        try:
            reader = wire.PacketReader(sock)
            seq, payload = reader.read_packet()
            if payload[:1] == b"\xff":
                raise wire.parse_err(payload)
            hello = wire.parse_handshake_v10(payload)
            self.server_version = hello["version"]
            resp = wire.handshake_response_41(user, password, database, hello["nonce"])
            wire.send_packet(sock, seq + 1, resp)
            _, payload = reader.read_packet()
            if payload[:1] == b"\xff":
                raise wire.parse_err(payload)
            if payload[:1] not in (b"\x00", b"\xfe"):
                raise MySQLError(2027, "HY000", "unexpected auth reply")
        except BaseException:
            sock.close()
            raise
        sock.settimeout(None)
        self.sock = sock
        self.reader = reader

    def execute(self, sql: str) -> tuple[list[dict[str, Any]], dict[str, int]]:
        """COM_QUERY round trip → (rows, ok-stats). Text resultset or OK."""
        wire.send_packet(self.sock, 0, bytes([wire.COM_QUERY]) + sql.encode())
        _, payload = self.reader.read_packet()
        if payload[:1] == b"\xff":
            raise wire.parse_err(payload)
        if payload[:1] == b"\x00":
            return [], wire.parse_ok(payload)
        n_cols, _ = wire.read_lenenc_int(payload, 0)
        names = []
        for _ in range(n_cols):
            _, col = self.reader.read_packet()
            names.append(wire.parse_column_definition(col))
        _, eof = self.reader.read_packet()  # EOF after column definitions
        rows: list[dict[str, Any]] = []
        while True:
            _, payload = self.reader.read_packet()
            first = payload[:1]
            if first == b"\xff":
                raise wire.parse_err(payload)
            if first == b"\xfe" and len(payload) < 9:  # EOF/OK terminator
                return rows, {"affected_rows": 0, "last_insert_id": 0}
            values = wire.parse_text_row(payload, n_cols)
            rows.append(dict(zip(names, values)))

    def ping(self) -> None:
        wire.send_packet(self.sock, 0, bytes([wire.COM_PING]))
        _, payload = self.reader.read_packet()
        if payload[:1] != b"\x00":
            raise MySQLError(2006, "HY000", "ping failed")

    def is_stale(self) -> bool:
        """Pre-send liveness check (go-sql-driver connCheck model)."""
        try:
            self.sock.setblocking(False)
            self.sock.recv(1)
            return True  # EOF or unsolicited server bytes
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            return True
        finally:
            try:
                self.sock.setblocking(True)
            except OSError:
                pass

    def close(self) -> None:
        try:
            wire.send_packet(self.sock, 0, bytes([wire.COM_QUIT]))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


MySQLTx = PooledTx  # back-compat name: begin() returns the shared Tx


class MySQLDB(PooledSQLBase):
    dialect = "mysql"

    def __init__(
        self,
        host: str = "localhost",
        port: int = 3306,
        user: str = "root",
        password: str = "",
        database: str = "",
        connect_timeout: float = 5.0,
        max_open_conns: int = 4,
        ping_interval: float = 10.0,
    ) -> None:
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.database = database
        self.connect_timeout = connect_timeout
        self._init_pool(max_open_conns, ping_interval)

    @classmethod
    def from_config(cls, config: Any) -> "MySQLDB":
        return cls(
            host=config.get_or_default("DB_HOST", "localhost"),
            port=int(config.get_or_default("DB_PORT", "3306")),
            user=config.get_or_default("DB_USER", "root"),
            password=config.get_or_default("DB_PASSWORD", ""),
            database=config.get_or_default("DB_NAME", ""),
            max_open_conns=int(config.get_or_default("DB_MAX_OPEN_CONNS", "4")),
            ping_interval=float(config.get_or_default("DB_PING_INTERVAL", "10")),
        )

    # -- dialect hooks (base.py) -------------------------------------------
    def _dial(self) -> _MyConn:
        return _MyConn(self.host, self.port, self.user, self.password,
                       self.database, self.connect_timeout)

    def _conn_execute(self, conn: _MyConn, sql: str, args: tuple) -> tuple[list, dict]:
        return conn.execute(wire.interpolate(sql, args))

    def _is_broken_error(self, exc: Exception) -> bool:
        if isinstance(exc, MySQLError):
            # 2000-2999 are the CLIENT-side (CR_*) connection/protocol
            # failures; everything else (1xxx and the 3xxx+ server errors
            # of MySQL 5.7/8) is a server-reported SQL error on a clean
            # session (code-review r4)
            return 2000 <= exc.code < 3000
        return isinstance(exc, (OSError, ConnectionError))


def new_mysql(config: Any) -> MySQLDB:
    return MySQLDB.from_config(config)
