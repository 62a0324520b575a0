"""In-process PostgreSQL wire server for tests — the CI service-container
stand-in (SURVEY §4 tier 4), like kafka_broker.py / google_pubsub.py.

Speaks protocol v3 (datasource/sql/pg_wire.py): startup with **md5 auth**
(so the driver's real challenge/response path is exercised, not trust),
simple 'Q' queries, and the extended Parse/Bind/Describe/Execute/Sync
flow with text-format parameters. SQL executes on a shared in-memory
sqlite database ($n placeholders rewritten to ?), rows stream back as
RowDescription + DataRows with OIDs inferred from python values, errors
as ErrorResponse with SQLSTATE-ish codes. Per-connection transaction
status rides the ReadyForQuery byte (I/T/E) like a real backend.

The port's copy of ``gofr_tpu/testutil/postgres_server.py``; it imports nothing of the JAX package.
One difference: each accepted socket sets ``TCP_NODELAY`` (the
reference's fake answers a statement in about 40 ms on Linux loopback,
its small sends held by Nagle's algorithm behind the client's delayed
ACK); no byte on the wire changes.
"""

from __future__ import annotations

import re
import socket
import sqlite3
import struct
import threading
from typing import Any

from gofr_tpu_torch.datasource.sql import pg_wire as wire

_DOLLAR = re.compile(r"\$(\d+)")


class MiniPostgresServer:
    def __init__(self, port: int = 0, user: str = "gofr", password: str = "secret",
                 database: str = "gofrdb") -> None:
        self.user, self.password, self.database = user, password, database
        # one shared in-memory DB across connections (like a real server)
        self._db = sqlite3.connect(":memory:", check_same_thread=False)
        self._db.row_factory = sqlite3.Row
        self._db.isolation_level = None
        self._db_lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._running = True
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(8)
        self.port = self._server.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="pg-server").start()

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass

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

    def _serve(self, conn: socket.socket) -> None:
        try:
            if not self._startup(conn):
                return
            self._session(conn)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _startup(self, conn: socket.socket) -> bool:
        rx = lambda n: wire.recv_exact(conn, n)  # noqa: E731
        (size,) = struct.unpack(">i", rx(4))
        r = wire.Reader(rx(size - 4))
        version = r.int32()
        if version != wire.PROTOCOL_VERSION:
            conn.sendall(wire.encode_error(f"unsupported protocol {version}", "08P01"))
            return False
        params: dict[str, str] = {}
        while r.remaining() > 1:
            key = r.cstr()
            if not key:
                break
            params[key] = r.cstr()
        user = params.get("user", "")

        # md5 challenge/response — the real auth path, not trust
        salt = b"\x01\x02\x03\x04"
        conn.sendall(wire.encode_auth(wire.AUTH_MD5, salt))
        mtype, pr = wire.read_message(rx)
        if mtype != b"p":
            conn.sendall(wire.encode_error("expected password message", "08P01"))
            return False
        expected = wire.md5_password(self.user, self.password, salt)
        if user != self.user or pr.cstr() != expected:
            conn.sendall(wire.encode_error(
                f'password authentication failed for user "{user}"', "28P01"))
            return False
        conn.sendall(
            wire.encode_auth(wire.AUTH_OK)
            + wire.encode_param_status("server_version", "16.0 (gofr-mini)")
            + wire.encode_param_status("client_encoding", "UTF8")
            + wire.msg(wire.BACKEND_KEY, struct.pack(">ii", 1, 1))
            + wire.encode_ready(b"I")
        )
        return True

    # -- query session -----------------------------------------------------
    def _session(self, conn: socket.socket) -> None:
        rx = lambda n: wire.recv_exact(conn, n)  # noqa: E731
        stmts: dict[str, str] = {}
        portals: dict[str, tuple[str, list]] = {}
        txn = b"I"  # I idle, T in transaction, E failed transaction

        def run_sql(sql: str, params: list) -> bytes:
            nonlocal txn
            sqlite_sql = _DOLLAR.sub("?", sql)
            upper = sql.strip().upper()
            try:
                with self._db_lock:
                    cur = self._db.execute(sqlite_sql, params)
                    rows = cur.fetchall() if cur.description else []
            except sqlite3.Error as exc:
                if txn == b"T":
                    txn = b"E"  # statement failed: transaction is poisoned
                return wire.encode_error(str(exc), "42601")
            out = b""
            if cur.description:
                names = [d[0] for d in cur.description]

                def col_oid(i: int) -> int:
                    # first NON-NULL value decides the column type — a NULL
                    # in row 1 must not stringify the whole column
                    for row in rows:
                        if row[i] is not None:
                            return wire.oid_for_python(row[i])
                    return wire.OID_TEXT

                cols = [(name, col_oid(i)) for i, name in enumerate(names)]
                out += wire.encode_row_description(cols)
                for row in rows:
                    out += wire.encode_data_row(list(row))
                tag = f"SELECT {len(rows)}"
            else:
                verb = upper.split()[0] if upper.split() else "OK"
                n = cur.rowcount if cur.rowcount >= 0 else 0
                tag = f"INSERT 0 {n}" if verb == "INSERT" else f"{verb} {n}"
            if upper.startswith("BEGIN"):
                txn, tag = b"T", "BEGIN"
            elif upper.startswith("COMMIT"):
                txn, tag = b"I", "COMMIT"
            elif upper.startswith("ROLLBACK"):
                txn, tag = b"I", "ROLLBACK"
            return out + wire.encode_command_complete(tag)

        while self._running:
            mtype, r = wire.read_message(rx)
            if mtype == b"Q":  # simple query
                conn.sendall(run_sql(r.cstr(), []) + wire.encode_ready(txn))
            elif mtype == b"P":  # Parse
                name, query = r.cstr(), r.cstr()
                stmts[name] = query
                conn.sendall(wire.msg(wire.PARSE_COMPLETE))
            elif mtype == b"B":  # Bind
                portal, stmt = r.cstr(), r.cstr()
                for _ in range(r.int16()):
                    r.int16()  # param format codes
                params: list[Any] = []
                for _ in range(r.int16()):
                    size = r.int32()
                    params.append(None if size < 0 else r.take(size).decode())
                for _ in range(r.int16()):
                    r.int16()  # result format codes
                if stmt not in stmts:
                    conn.sendall(wire.encode_error(f"unknown statement {stmt!r}", "26000"))
                else:
                    portals[portal] = (stmts[stmt], params)
                    conn.sendall(wire.msg(wire.BIND_COMPLETE))
            elif mtype == b"D":  # Describe — row shape resolved at Execute
                r.take(1), r.cstr()
                conn.sendall(wire.msg(wire.NO_DATA))
            elif mtype == b"E":  # Execute
                portal = r.cstr()
                r.int32()  # max rows
                if portal not in portals:
                    conn.sendall(wire.encode_error(f"unknown portal {portal!r}", "34000"))
                else:
                    sql, params = portals[portal]
                    conn.sendall(run_sql(sql, params))
            elif mtype == b"S":  # Sync
                conn.sendall(wire.encode_ready(txn))
            elif mtype == b"C":  # Close
                r.take(1), r.cstr()
                conn.sendall(wire.msg(wire.CLOSE_COMPLETE))
            elif mtype == b"X":  # Terminate
                return
            else:
                conn.sendall(
                    wire.encode_error(f"unsupported message {mtype!r}", "0A000")
                    + wire.encode_ready(txn)
                )

    # -- test inspection ---------------------------------------------------
    def execute(self, sql: str, *args: Any) -> list[tuple]:
        with self._db_lock:
            cur = self._db.execute(sql, args)
            return [tuple(r) for r in cur.fetchall()] if cur.description else []


def start_postgres_server(**kw: Any) -> MiniPostgresServer:
    return MiniPostgresServer(**kw)
