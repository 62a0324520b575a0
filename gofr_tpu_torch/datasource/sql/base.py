"""Shared pooled-SQL facade for the wire dialects (postgres, mysql).

One implementation of the DB contract (``query``/``query_row``/``exec``/
``select``/``begin``/``health_check`` — db.go:47-334) over the
ConnectionPool, parameterized by three dialect hooks:

- ``_dial()`` → a connection object (``execute``/``ping``/``close``,
  optionally ``is_stale`` for the pool's checkout liveness check)
- ``_conn_execute(conn, sql, args)`` → (rows, result) — placeholder
  rewriting/interpolation happens here
- ``_is_broken_error(exc)`` → whether the SESSION is unusable (socket
  dead, protocol desync) as opposed to a clean server-side SQL error.
  This classification decides whether a connection returns to the pool
  — getting it wrong either leaks poisoned sessions or needlessly
  shreds healthy ones (code-review r4: PgError subclasses
  ConnectionError, so a naive ``except ConnectionError`` miscounts SQL
  errors as dead connections).

Statement execution is SINGLE-attempt: stale pooled sessions are culled
by the pool's pre-send liveness check, never by re-executing a statement
that may already have run (the duplicate-INSERT hazard of blanket
retries).

The port's copy of ``gofr_tpu/datasource/sql/base.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import time
from typing import Any

from gofr_tpu_torch.datasource.sql.pool import ConnectionPool
from gofr_tpu_torch.datasource.sql.sqlite import observe_query, sql_span


class PooledTx:
    """Transaction pinned to ONE pooled connection (db.go:124-185): the
    connection leaves the pool at ``begin()`` and returns at commit/
    rollback, so no other thread's statement can interleave into the
    open transaction. A clean SQL error keeps both the transaction and
    the connection alive (the caller decides to rollback); only a broken
    session finishes the transaction implicitly."""

    def __init__(self, db: "PooledSQLBase", conn: Any, pool: Any = None) -> None:
        self._db = db
        # release into the pool the connection was ACQUIRED from — after a
        # close()+reuse pool swap, releasing into the new pool would
        # corrupt its accounting
        self._pool = pool if pool is not None else db._pool
        self._conn = conn
        self._done = False

    def query(self, sql: str, *args: Any) -> list[dict[str, Any]]:
        return self._run(sql, args)[0]

    def query_row(self, sql: str, *args: Any) -> dict[str, Any] | None:
        rows = self.query(sql, *args)
        return rows[0] if rows else None

    def exec(self, sql: str, *args: Any) -> Any:
        return self._run(sql, args)[1]

    def _run(self, sql: str, args: tuple) -> tuple[list[dict[str, Any]], Any]:
        if self._done:
            raise RuntimeError("transaction already finished")
        try:
            return self._db._conn_execute(self._conn, sql, args)
        except Exception as exc:
            if self._db._is_broken_error(exc):
                # the transaction is lost with the session
                self._done = True
                self._pool.release(self._conn, broken=True)
            raise

    def _finish(self, sql: str) -> None:
        if self._done:
            raise RuntimeError("transaction already finished")
        broken = False
        try:
            self._db._conn_execute(self._conn, sql, ())
        except Exception as exc:
            broken = self._db._is_broken_error(exc)
            raise
        finally:
            self._done = True
            self._pool.release(self._conn, broken=broken)

    def commit(self) -> None:
        self._finish("COMMIT")

    def rollback(self) -> None:
        self._finish("ROLLBACK")


class PooledSQLBase:
    """Dialect facade over the pool; subclasses set ``dialect`` and the
    three hooks (see module docstring)."""

    dialect = "sql"

    def _init_pool(self, max_open_conns: int, ping_interval: float) -> None:
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None
        self._max_open_conns = max_open_conns
        self._ping_interval = ping_interval
        self._pool = ConnectionPool(
            self._dial,
            max_open=max_open_conns,
            ping_interval=ping_interval,
            dialect=self.dialect,
        )

    def _live_pool(self) -> ConnectionPool:
        """The single-session drivers re-handshook transparently after
        close(); the pooled facade keeps that contract by swapping in a
        fresh pool when the old one was closed (code-review r4)."""
        if self._pool._closed:
            self._pool = ConnectionPool(
                self._dial,
                max_open=self._max_open_conns,
                ping_interval=self._ping_interval,
                dialect=self.dialect,
            )
            self._pool.set_observers(self._logger, self._metrics)
            # the original pool got its keepalive in connect(); a silently
            # recreated one must honor the same reconnect promise
            self._pool.start_ping_loop()
        return self._pool

    # -- dialect hooks -----------------------------------------------------
    def _dial(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def _conn_execute(self, conn: Any, sql: str, args: tuple) -> tuple[list, Any]:
        raise NotImplementedError  # pragma: no cover - abstract

    def _is_broken_error(self, exc: Exception) -> bool:
        raise NotImplementedError  # pragma: no cover - abstract

    def _health_details(self) -> dict[str, Any]:
        return {}

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger
        self._pool.set_observers(self._logger, self._metrics)

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics
        self._pool.set_observers(self._logger, self._metrics)

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        pool = self._live_pool()
        # gofrlint: disable=cancel-unreachable -- pool.acquire() is internally bounded by checkout_timeout and raises once close() flips _closed
        conn = pool.acquire()
        pool.release(conn)
        pool.start_ping_loop()
        if self._logger:
            self._logger.debug(
                f"connected to {self.dialect} at {self.host}:{self.port}"
            )

    # -- pooled execution --------------------------------------------------
    def _execute(self, sql: str, args: tuple = ()) -> tuple[list, Any]:
        pool = self._live_pool()
        # gofrlint: disable=cancel-unreachable -- pool.acquire() is internally bounded by checkout_timeout and raises once close() flips _closed
        conn = pool.acquire()
        try:
            out = self._conn_execute(conn, sql, args)
        except Exception as exc:
            pool.release(conn, broken=self._is_broken_error(exc))
            raise
        pool.release(conn)
        return out

    # -- DB contract -------------------------------------------------------
    def _observe(self, query: str, start: float) -> None:
        observe_query(self._logger, self._metrics, self.dialect,
                      f"{self.host}:{self.port}", query, start)

    def _span(self, op: str):
        return sql_span(self._tracer, op)

    def query(self, sql: str, *args: Any) -> list[dict[str, Any]]:
        start = time.perf_counter()
        with self._span("query"):
            rows, _ = self._execute(sql, args)
        self._observe(sql, start)
        return rows

    def query_row(self, sql: str, *args: Any) -> dict[str, Any] | None:
        rows = self.query(sql, *args)
        return rows[0] if rows else None

    def exec(self, sql: str, *args: Any) -> Any:
        start = time.perf_counter()
        with self._span("exec"):
            _, result = self._execute(sql, args)
        self._observe(sql, start)
        return result

    def select(self, target: Any, sql: str, *args: Any) -> Any:
        from gofr_tpu_torch.datasource.sql.sqlite import bind_rows

        return bind_rows(self.query(sql, *args), target)

    def begin(self) -> PooledTx:
        pool = self._live_pool()
        # gofrlint: disable=cancel-unreachable -- pool.acquire() is internally bounded by checkout_timeout and raises once close() flips _closed
        conn = pool.acquire()
        try:
            self._conn_execute(conn, "BEGIN", ())
        except BaseException as exc:
            broken = not isinstance(exc, Exception) or self._is_broken_error(exc)
            pool.release(conn, broken=broken)
            raise
        return PooledTx(self, conn, pool)

    def pool_stats(self) -> dict[str, int]:
        return self._pool.stats()

    def close(self) -> None:
        self._pool.close_all()

    def health_check(self) -> dict[str, Any]:
        try:
            self.query("SELECT 1 AS ok")
            return {
                "status": "UP",
                "details": {
                    "dialect": self.dialect,
                    "host": f"{self.host}:{self.port}",
                    "database": self.database,
                    "pool": self.pool_stats(),
                    **self._health_details(),
                },
            }
        except Exception as exc:
            return {
                "status": "DOWN",
                "details": {
                    "dialect": self.dialect,
                    "host": f"{self.host}:{self.port}",
                    "error": str(exc),
                },
            }
