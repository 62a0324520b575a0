"""SQLite-backed DB implementing the DB contract.

Reference parity: datasource/sql/db.go — every operation logs a QUERY line
and records ``app_sql_stats`` (db.go:47-66); ``select`` fills dataclasses or
dicts by column name (db.go:214-334); ``begin`` returns a Tx (db.go:124-185);
health_check reports dialect + reachability (sql/health.go). The reference's
MySQL/Postgres/Supabase/CockroachDB dialects (sql.go:212-237) map to this
contract; sqlite ships in-tree because the image has no DB servers — the
dialect hook (``DB_DIALECT``) keeps the seam.

The port's copy of ``gofr_tpu/datasource/sql/sqlite.py``, with one
deliberate difference (ROADMAP Queue C 42). The reference's ``begin``
takes the connection's lock and releases it before it returns the
``Tx``, and its ``exec`` commits the one shared connection, so an
``exec`` from another thread while a ``Tx`` is open commits the
``Tx``'s rows and the ``Tx``'s ``rollback`` leaves them in place. Here
``begin`` holds the connection's lock (a plain ``threading.Lock``) for
the transaction's life:

- any other thread's ``query``/``exec``/``select``/``health_check``/
  ``begin`` waits until the ``Tx`` commits or rolls back;
- ``commit``/``rollback`` may come from any thread (a plain lock, unlike
  an ``RLock``, may be released by a thread that did not take it), and
  release the lock exactly once, even when the statement raises: a
  ``COMMIT`` that fails is followed by a ``ROLLBACK`` before the release,
  so no half-open transaction outlives the lock. A second ``commit`` or
  ``rollback``, or a statement on a finished ``Tx``, raises
  ``RuntimeError("transaction already finished")``, as the wire
  dialects' ``PooledTx`` does;
- a statement on the database itself from the thread that opened the
  ``Tx`` raises ``RuntimeError`` instead of waiting on its own lock (a
  deadlock) or committing its own ``Tx`` half done: run it through the
  ``Tx``.
"""

from __future__ import annotations

import dataclasses
import io
import sqlite3
import threading
import time
import typing
from typing import Any


class SQLLog:
    """Pretty-printable query log (db.go QueryLog)."""

    def __init__(self, query: str, duration_us: int) -> None:
        self.query = query
        self.duration = duration_us

    def pretty_print(self, writer: io.TextIOBase) -> None:
        writer.write(f"\x1b[38;5;8mSQL\x1b[0m {self.duration:>8}µs {self.query}")

    def __str__(self) -> str:
        return f"SQL {self.duration}µs {self.query}"


def observe_query(logger: Any, metrics: Any, dialect: str, host: str,
                  query: str, start: float) -> None:
    """Per-query structured log + app_sql_stats histogram (db.go:47-66),
    shared by every SQL dialect."""
    duration_us = int((time.perf_counter() - start) * 1e6)
    if logger:
        logger.debug(SQLLog(query, duration_us))
    if metrics:
        metrics.record_histogram(
            "app_sql_stats", duration_us / 1000.0, hostname=host, database=dialect,
        )


def sql_span(tracer: Any, op: str):
    if tracer is not None:
        return tracer.start_span(f"sql {op}", kind="client")
    import contextlib

    return contextlib.nullcontext()


def bind_rows(rows: list[dict[str, Any]], target: Any) -> Any:
    """db.go:214-334 — bind row dicts into a list of dataclasses (or pass
    them through for dict targets). Shared by every SQL dialect."""
    if target is None or target is dict:
        return rows
    if isinstance(target, type) and dataclasses.is_dataclass(target):
        hints = typing.get_type_hints(target)
        names = {f.name for f in dataclasses.fields(target)}
        out = []
        for row in rows:
            kwargs = {}
            for col, val in row.items():
                key = col if col in names else col.lower()
                if key in names:
                    hint = hints.get(key)
                    if hint in (int, float, str, bool) and val is not None:
                        val = hint(val)
                    kwargs[key] = val
            out.append(target(**kwargs))
        return out
    raise TypeError("select target must be dict or a dataclass type")


class Tx:
    """A transaction on the one shared connection. It holds the
    connection's lock from ``begin`` until ``commit``/``rollback`` (see the
    module docstring)."""

    def __init__(self, db: "SQLite") -> None:
        self._db = db
        self._conn = db._conn
        self._done = False
        self._conn.execute("BEGIN")

    def _live(self) -> sqlite3.Connection:
        if self._done:
            raise RuntimeError("transaction already finished")
        return self._conn

    def query(self, sql: str, *args: Any) -> list[dict[str, Any]]:
        return self._db._rows(self._live().execute(sql, args))

    def query_row(self, sql: str, *args: Any) -> dict[str, Any] | None:
        rows = self.query(sql, *args)
        return rows[0] if rows else None

    def exec(self, sql: str, *args: Any) -> Any:
        return self._live().execute(sql, args)

    def _finish(self, commit: bool) -> None:
        conn = self._live()
        self._done = True
        try:
            if commit:
                try:
                    conn.commit()
                except BaseException:
                    conn.rollback()
                    raise
            else:
                conn.rollback()
        finally:
            self._db._end_tx()

    def commit(self) -> None:
        self._finish(True)

    def rollback(self) -> None:
        self._finish(False)


class SQLite:
    """The in-tree SQL driver (provider pattern + DB contract)."""

    dialect = "sqlite"

    def __init__(self, database: str = "./app.db") -> None:
        self.database = database
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.Lock()
        self._tx_thread: int | None = None  # the thread that opened the open Tx

    @classmethod
    def from_config(cls, config: Any) -> "SQLite":
        return cls(config.get_or_default("DB_NAME", "./app.db"))

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        self._conn = sqlite3.connect(self.database, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.isolation_level = None  # explicit transactions
        if self._logger:
            self._logger.debug(f"connected to sqlite database {self.database}")

    # -- DB contract -----------------------------------------------------------
    def _observe(self, query: str, start: float) -> None:
        observe_query(self._logger, self._metrics, self.dialect, self.database,
                      query, start)

    def _span(self, op: str):
        return sql_span(self._tracer, op)

    def _rows(self, cursor: sqlite3.Cursor) -> list[dict[str, Any]]:
        return [dict(row) for row in cursor.fetchall()]

    def _locked(self):
        """The connection's lock, refused to the thread whose own ``Tx`` holds
        it."""
        if self._tx_thread == threading.get_ident():
            raise RuntimeError(
                "this thread holds an open transaction on the database: run the "
                "statement through the Tx, or commit or roll it back first"
            )
        return self._lock

    def _end_tx(self) -> None:
        self._tx_thread = None
        self._lock.release()

    def query(self, sql: str, *args: Any) -> list[dict[str, Any]]:
        start = time.perf_counter()
        with self._span("query"), self._locked():
            cursor = self._conn.execute(sql, args)
            rows = self._rows(cursor)
        self._observe(sql, start)
        return rows

    def query_row(self, sql: str, *args: Any) -> dict[str, Any] | None:
        rows = self.query(sql, *args)
        return rows[0] if rows else None

    def exec(self, sql: str, *args: Any) -> Any:
        start = time.perf_counter()
        with self._span("exec"), self._locked():
            cursor = self._conn.execute(sql, args)
            self._conn.commit()
        self._observe(sql, start)
        return cursor

    def select(self, target: Any, sql: str, *args: Any) -> Any:
        """db.go:214-334 — bind rows into a list of dataclasses/dicts."""
        return bind_rows(self.query(sql, *args), target)

    def begin(self) -> Tx:
        """Open a transaction that holds the connection's lock until its
        ``commit`` or ``rollback`` (Queue C 42: the reference released it
        here)."""
        lock = self._locked()  # bound by name, so the analyzer sees the wait
        # gofrlint: disable=cancel-unreachable -- in-process mutex guarding a local sqlite handle; held for one statement, or for a Tx until its commit or rollback
        lock.acquire()
        try:
            tx = Tx(self)
        except BaseException:
            self._lock.release()
            raise
        self._tx_thread = threading.get_ident()
        return tx

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def health_check(self) -> dict[str, Any]:
        try:
            with self._locked():
                self._conn.execute("SELECT 1")
            return {"status": "UP", "details": {"database": self.database, "dialect": self.dialect}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"database": self.database, "error": str(exc)}}


def new_sql(config: Any) -> Any:
    """Dialect dispatch (sql.go:212-237): sqlite (embedded), postgres
    (own v3 wire client, sql/postgres.py), and mysql (own 4.1 wire
    client, sql/mysql.py) ship in-tree; other dialects raise with a
    clear message so apps fail fast."""
    dialect = config.get_or_default("DB_DIALECT", "sqlite").lower()
    if dialect == "sqlite":
        return SQLite.from_config(config)
    if dialect in ("postgres", "postgresql", "supabase", "cockroachdb"):
        # supabase/cockroach speak the postgres wire protocol (sql.go:223-234)
        from gofr_tpu_torch.datasource.sql.postgres import PostgresDB

        return PostgresDB.from_config(config)
    if dialect in ("mysql", "mariadb"):
        from gofr_tpu_torch.datasource.sql.mysql import MySQLDB

        return MySQLDB.from_config(config)
    raise ValueError(
        f"DB_DIALECT={dialect} requires an external driver module; "
        "in-tree dialects: sqlite, postgres, mysql"
    )
