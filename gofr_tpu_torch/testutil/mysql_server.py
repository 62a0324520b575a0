"""In-process MySQL wire server for tests — the CI service-container
stand-in (SURVEY §4 tier 4; the reference CI runs a real MySQL on :2001,
go.yml:38-77), like postgres_server.py.

Speaks protocol 4.1 (datasource/sql/mysql_wire.py): HandshakeV10 with
**mysql_native_password** challenge/response (so the driver's real
scramble path is exercised), COM_QUERY text resultsets, COM_PING,
COM_QUIT. SQL executes on a shared in-memory sqlite database; rows
stream back as column definitions + text rows, errors as ERR packets
with MySQL-ish codes. ``kill_connections()`` severs every live session
for reconnect tests.

The port's copy of ``gofr_tpu/testutil/mysql_server.py``; it imports nothing of the JAX package.
One difference: each accepted socket sets ``TCP_NODELAY`` (the
reference's fake answers a statement in about 40 ms on Linux loopback,
its small sends held by Nagle's algorithm behind the client's delayed
ACK); no byte on the wire changes.
"""

from __future__ import annotations

import os
import socket
import sqlite3
import threading
from typing import Any

from gofr_tpu_torch.datasource.sql import mysql_wire as wire


class MiniMySQLServer:
    def __init__(self, port: int = 0, user: str = "gofr", password: str = "secret",
                 database: str = "gofrdb") -> None:
        self.user, self.password, self.database = user, password, database
        self._db = sqlite3.connect(":memory:", check_same_thread=False)
        self._db.row_factory = sqlite3.Row
        self._db.isolation_level = None
        self._db_lock = threading.Lock()
        self._running = True
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(8)
        self.port = self._server.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="mysql-server").start()

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        self.kill_connections()

    def kill_connections(self) -> None:
        """Sever every live session (reconnect-after-kill tests)."""
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -- connection handling ----------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            # a reply is several small sends: without this, Nagle's algorithm
            # holds each behind the client's delayed ACK (~40 ms a statement)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            if not self._handshake(sock):
                return
            reader = wire.PacketReader(sock)
            while True:
                _, payload = reader.read_packet()
                if not payload:
                    return
                cmd = payload[0]
                if cmd == wire.COM_QUIT:
                    return
                if cmd == wire.COM_PING:
                    wire.send_packet(sock, 1, wire.ok_packet())
                elif cmd == wire.COM_QUERY:
                    self._query(sock, payload[1:].decode("utf-8", "replace"))
                else:
                    wire.send_packet(sock, 1, wire.err_packet(
                        1047, "08S01", f"unknown command 0x{cmd:02x}"
                    ))
        except (wire.MySQLError, OSError, IndexError, ValueError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _handshake(self, sock: socket.socket) -> bool:
        nonce = os.urandom(20).replace(b"\x00", b"\x01")
        seq = wire.send_packet(
            sock, 0,
            wire.handshake_v10("8.0.0-mini", 1, nonce,
                               wire.CLIENT_PROTOCOL_41
                               | wire.CLIENT_SECURE_CONNECTION
                               | wire.CLIENT_PLUGIN_AUTH
                               | wire.CLIENT_CONNECT_WITH_DB),
        )
        reader = wire.PacketReader(sock)
        _, payload = reader.read_packet()
        resp = wire.parse_handshake_response(payload)
        want = wire.native_password_scramble(self.password, nonce)
        if resp["user"] != self.user or resp["auth"] != want:
            wire.send_packet(sock, seq + 1, wire.err_packet(
                1045, "28000", f"Access denied for user '{resp['user']}'"
            ))
            return False
        wire.send_packet(sock, seq + 1, wire.ok_packet())
        return True

    # -- query execution ---------------------------------------------------
    def _query(self, sock: socket.socket, sql: str) -> None:
        stripped = sql.strip().rstrip(";")
        try:
            with self._db_lock:
                cur = self._db.execute(stripped)
                rows = cur.fetchall() if cur.description else []
                description = cur.description
                affected = cur.rowcount if cur.rowcount >= 0 else 0
                last_id = cur.lastrowid or 0
        except sqlite3.Error as exc:
            wire.send_packet(sock, 1, wire.err_packet(1064, "42000", str(exc)))
            return
        if description is None:
            wire.send_packet(sock, 1, wire.ok_packet(affected, last_id))
            return
        names = [d[0] for d in description]
        seq = wire.send_packet(sock, 1, wire.lenenc_int(len(names)))
        for name in names:
            seq = wire.send_packet(sock, seq, wire.column_definition(name))
        seq = wire.send_packet(sock, seq, wire.eof_packet())
        for row in rows:
            seq = wire.send_packet(sock, seq, wire.text_row(list(row)))
        wire.send_packet(sock, seq, wire.eof_packet())
