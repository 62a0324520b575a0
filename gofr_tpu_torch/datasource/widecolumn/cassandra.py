"""Cassandra wire driver: CQL binary protocol v4 over TCP.

Reference parity: the Cassandra interface at
pkg/gofr/container/datasources.go:42-194 (Query/Exec/
ExecCAS, named logged/unlogged batches, *WithCtx variants) over gocql;
here the same surface speaks the native protocol directly
(widecolumn/cql_wire.py) so no vendor SDK is needed. API mirrors
EmbeddedWideColumnStore, so either backend serves the same app code;
``new_widecolumn_store`` picks wire vs embedded by config
(CASSANDRA_HOST selects this driver).

Values interpolate client-side (CQL '' escaping — the MySQL-dialect
recipe) so the unprepared QUERY path carries no typed-value negotiation;
results return typed through RESULT column specs.

The port's copy of ``gofr_tpu/datasource/widecolumn/cassandra.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
from typing import Any

from gofr_tpu_torch.datasource.widecolumn import cql_wire as wire
from gofr_tpu_torch.datasource.widecolumn.cql_wire import CQLError

LOGGED_BATCH = wire.LOGGED_BATCH
UNLOGGED_BATCH = wire.UNLOGGED_BATCH


class CassandraClient:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 9042,
        keyspace: str = "",
        connect_timeout: float = 5.0,
    ) -> None:
        self.host = host
        self.port = port
        self.keyspace = keyspace
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None
        self._rbuf = b""
        self._streams = itertools.count(1)
        self._lock = threading.Lock()
        self._batches: dict[str, tuple[int, list[str]]] = {}
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "CassandraClient":
        return cls(
            host=config.get_or_default("CASSANDRA_HOST", "localhost"),
            port=int(config.get_or_default("CASSANDRA_PORT", "9042")),
            keyspace=config.get_or_default("CASSANDRA_KEYSPACE", ""),
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics
        try:
            metrics.new_histogram(
                "app_cassandra_stats", "Wide-column store operation latency"
            )
        except Exception:
            pass

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        _, opcode, body = self._roundtrip(wire.encode_startup(0))
        if opcode != wire.OP_READY:
            raise CQLError(0, f"expected READY after STARTUP, got 0x{opcode:02x}")
        if self.keyspace:
            self._request(f'USE "{self.keyspace}"')
        if self._logger:
            self._logger.info(
                f"connected to Cassandra at {self.host}:{self.port}"
            )

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # -- wire ------------------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        assert self._sock is not None
        while len(self._rbuf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise CQLError(0, "connection closed by server")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _roundtrip(self, frame: bytes) -> tuple[int, int, bytes]:
        if self._sock is None:
            raise CQLError(0, "not connected (call connect())")
        with self._lock:
            # gofrlint: disable=hold-and-block -- CQL request/response
            # pairing on one stream id: the lock must span send+recv
            self._sock.sendall(frame)
            head = self._recv_exact(9)
            _, stream, opcode, length = wire.parse_frame_header(head)
            body = self._recv_exact(length) if length else b""
        if opcode == wire.OP_ERROR:
            raise wire.decode_error(body)
        return stream, opcode, body

    def _request(self, query: str) -> list[dict[str, Any]]:
        stream = next(self._streams) & 0x7FFF
        _, opcode, body = self._roundtrip(wire.encode_query(stream, query))
        if opcode != wire.OP_RESULT:
            raise CQLError(0, f"unexpected opcode 0x{opcode:02x}")
        _, rows = wire.decode_result(body)
        return rows

    def _observe(self, op: str, start: float) -> None:
        if self._metrics:
            self._metrics.record_histogram(
                "app_cassandra_stats", time.perf_counter() - start, operation=op
            )

    def _span(self, name: str):
        import contextlib

        if self._tracer is not None:
            return self._tracer.start_span(name, kind="client")
        return contextlib.nullcontext()

    # -- WideColumnStore contract (datasources.go:42-194) ----------------------
    def query(self, target: Any, stmt: str, *values: Any) -> Any:
        """Run a SELECT; appends row dicts into ``target`` (list) and also
        returns them (the reference scans into a destination slice)."""
        start = time.perf_counter()
        with self._span("cassandra.query"):
            rows = self._request(wire.interpolate(stmt, values))
        self._observe("query", start)
        if isinstance(target, list):
            target.extend(rows)
        return rows

    def exec(self, stmt: str, *values: Any) -> None:
        start = time.perf_counter()
        with self._span("cassandra.exec"):
            self._request(wire.interpolate(stmt, values))
        self._observe("exec", start)

    def exec_cas(self, target: Any, stmt: str, *values: Any) -> bool:
        """Lightweight transaction: returns Cassandra's ``[applied]``;
        on False the previous values (if returned) extend ``target``."""
        start = time.perf_counter()
        with self._span("cassandra.exec_cas"):
            rows = self._request(wire.interpolate(stmt, values))
        self._observe("exec_cas", start)
        if not rows:
            return True
        applied = bool(rows[0].get("[applied]", True))
        if not applied and isinstance(target, list):
            target.extend(
                {k: v for k, v in r.items() if k != "[applied]"} for r in rows
            )
        return applied

    # -- batches (client-accumulated, wire-executed) ---------------------------
    def new_batch(self, name: str, batch_type: int = LOGGED_BATCH) -> None:
        with self._lock:
            self._batches[name] = (batch_type, [])

    def batch_query(self, name: str, stmt: str, *values: Any) -> None:
        with self._lock:
            if name not in self._batches:
                raise KeyError(f"batch {name!r} not created")
            self._batches[name][1].append(wire.interpolate(stmt, values))

    def execute_batch(self, name: str) -> None:
        with self._lock:
            entry = self._batches.pop(name, None)
        if entry is None:
            raise KeyError(f"batch {name!r} not created")
        batch_type, queries = entry
        start = time.perf_counter()
        stream = next(self._streams) & 0x7FFF
        with self._span("cassandra.batch"):
            _, opcode, body = self._roundtrip(
                wire.encode_batch(stream, batch_type, queries)
            )
        if opcode != wire.OP_RESULT:
            raise CQLError(0, f"unexpected opcode 0x{opcode:02x}")
        self._observe("execute_batch", start)

    def execute_batch_cas(self, name: str, *dest: Any) -> bool:
        """Batch with CAS statements: applied iff the server applied the
        batch (kind Rows with [applied]=false reports the conflict)."""
        with self._lock:
            entry = self._batches.pop(name, None)
        if entry is None:
            raise KeyError(f"batch {name!r} not created")
        batch_type, queries = entry
        stream = next(self._streams) & 0x7FFF
        _, opcode, body = self._roundtrip(
            wire.encode_batch(stream, batch_type, queries)
        )
        if opcode != wire.OP_RESULT:
            raise CQLError(0, f"unexpected opcode 0x{opcode:02x}")
        _, rows = wire.decode_result(body)
        if not rows:
            return True
        return bool(rows[0].get("[applied]", True))

    # -- health ----------------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            # the canonical liveness probe — CQL has no FROM-less SELECT
            self._request("SELECT release_version FROM system.local")
            return {
                "status": "UP",
                "details": {
                    "backend": "cassandra-wire",
                    "host": f"{self.host}:{self.port}",
                    "keyspace": self.keyspace,
                },
            }
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": str(exc)}}
