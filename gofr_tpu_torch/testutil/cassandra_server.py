"""In-process Cassandra server: CQL binary protocol v4 over TCP, storage
via the embedded wide-column store.

Pairs with datasource/widecolumn/cassandra.py the way MiniMySQLServer
pairs with the MySQL dialect. STARTUP→READY, QUERY→RESULT (typed rows /
void), BATCH→RESULT with logged-batch atomicity, CAS statements (IF
NOT EXISTS / UPDATE ... IF) answered with the ``[applied]`` row shape
real servers use; errors come back as ERROR frames with CQL error codes.

The port's copy of ``gofr_tpu/testutil/cassandra_server.py``; it imports nothing of the JAX package.
Two differences, neither a byte on the wire: each accepted socket sets
``TCP_NODELAY``, as the port's other fakes do (ROADMAP Queue C 43 and 50), and
``commands`` counts the requests served: ``STARTUP``, ``OPTIONS``, ``QUERY``,
``BATCH``, and ``PROBE`` for the ``system.local`` health query (counted under
``QUERY`` too).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any

from gofr_tpu_torch.datasource.widecolumn import EmbeddedWideColumnStore
from gofr_tpu_torch.datasource.widecolumn import cql_wire as wire
from gofr_tpu_torch.testutil.ports import get_free_port


def _is_cas(stmt: str) -> bool:
    upper = stmt.upper()
    head = upper.lstrip()
    return ("IF NOT EXISTS" in upper and head.startswith("INSERT")) or (
        head.startswith("UPDATE") and " IF " in upper
    )


class _Conn:
    def __init__(self, server: "MiniCassandraServer", sock: socket.socket) -> None:
        self.server = server
        self.sock = sock
        self.rbuf = b""

    def _recv_exact(self, n: int) -> bytes | None:
        while len(self.rbuf) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            self.rbuf += chunk
        out, self.rbuf = self.rbuf[:n], self.rbuf[n:]
        return out

    def serve(self) -> None:
        try:
            while True:
                head = self._recv_exact(9)
                if head is None:
                    return
                _, stream, opcode, length = wire.parse_frame_header(head)
                body = self._recv_exact(length) if length else b""
                if body is None:
                    return
                try:
                    reply_op, reply_body = self.handle(opcode, body)
                except wire.CQLError as exc:
                    reply_op = wire.OP_ERROR
                    reply_body = wire.encode_error(exc.code, str(exc))
                except Exception as exc:  # noqa: BLE001 - surfaces on the wire
                    reply_op = wire.OP_ERROR
                    reply_body = wire.encode_error(0x0000, str(exc))
                self.sock.sendall(
                    wire.encode_frame(stream, reply_op, reply_body,
                                      response=True)
                )
        finally:
            self.sock.close()

    def _count(self, name: str) -> None:
        with self.server._lock:
            self.server.commands[name] = self.server.commands.get(name, 0) + 1

    def handle(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        self._count({wire.OP_STARTUP: "STARTUP", wire.OP_OPTIONS: "OPTIONS",
                     wire.OP_QUERY: "QUERY", wire.OP_BATCH: "BATCH"}.get(opcode, "OTHER"))
        if opcode == wire.OP_STARTUP:
            return wire.OP_READY, b""
        if opcode == wire.OP_OPTIONS:
            return wire.OP_SUPPORTED, wire.string_map({})
        if opcode == wire.OP_QUERY:
            query, pos = wire.read_long_string(body, 0)
            return wire.OP_RESULT, self._run_query(query)
        if opcode == wire.OP_BATCH:
            _, queries = wire.decode_batch(body)
            return wire.OP_RESULT, self._run_batch(queries)
        raise wire.CQLError(0x000A, f"unsupported opcode 0x{opcode:02x}")

    def _run_query(self, query: str) -> bytes:
        store = self.server.store
        head = query.strip().upper()
        if head.startswith("USE "):
            ks = query.strip()[4:].strip().strip('"')
            return struct.pack(">i", wire.RESULT_SET_KEYSPACE) + wire.string(ks)
        if _is_cas(query):
            prev: list[dict] = []
            applied = store.exec_cas(prev, query)
            rows = [{"[applied]": applied, **(prev[0] if prev else {})}]
            if not applied and not prev:
                rows = [{"[applied]": False}]
            return wire.encode_rows(rows)
        if head.startswith("SELECT"):
            if "SYSTEM.LOCAL" in head:  # canonical health probe
                self._count("PROBE")
                return wire.encode_rows([{"release_version": "4.0-mini"}])
            rows: list[dict] = []
            store.query(rows, query)
            return wire.encode_rows(rows)
        store.exec(query)
        return struct.pack(">i", wire.RESULT_VOID)

    def _run_batch(self, queries: list[str]) -> bytes:
        store = self.server.store
        name = f"__wire_batch_{id(self)}_{threading.get_ident()}"
        if any(_is_cas(q) for q in queries):
            # CAS batch: Cassandra applies all-or-nothing; emulate by
            # checking each CAS first, then running the batch atomically
            probe: list[dict] = []
            for q in queries:
                if _is_cas(q) and not store.exec_cas(probe, q):
                    return wire.encode_rows([{"[applied]": False}])
            non_cas = [q for q in queries if not _is_cas(q)]
            if non_cas:
                store.new_batch(name)
                for q in non_cas:
                    store.batch_query(name, q)
                store.execute_batch(name)
            return wire.encode_rows([{"[applied]": True}])
        store.new_batch(name)
        for q in queries:
            store.batch_query(name, q)
        store.execute_batch(name)
        return struct.pack(">i", wire.RESULT_VOID)


class MiniCassandraServer:
    def __init__(self, port: int = 0) -> None:
        self.port = port or get_free_port()
        self.store = EmbeddedWideColumnStore(":memory:")
        self._listener: socket.socket | None = None
        self._closed = False
        self._lock = threading.Lock()
        self.commands: dict[str, int] = {}

    def start(self) -> "MiniCassandraServer":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", self.port))
        self._listener.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=_Conn(self, sock).serve, daemon=True
            ).start()

    def close(self) -> None:
        self._closed = True
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        self.store.close()
