"""Embedded wide-column store: the WideColumnStore contract
(Cassandra/Scylla shape, reference container/datasources.go:42-194,
:600-635 — gocql batches, CAS) over sqlite.

Semantics carried over from the cassandra driver:
- ``query(target, stmt, *values)`` fills ``target`` (a list) with row
  dicts;
- ``exec_cas`` is compare-and-set: INSERT applies only if absent, UPDATE
  ... IF only if the condition row matches — returns applied True/False
  (cassandra/cassandra.go:15-27);
- named batches accumulate statements and execute atomically
  (``new_batch``/``batch_query``/``execute_batch`` — LoggedBatch ≈ one
  transaction here).

Placeholders use ``?`` (CQL and sqlite agree).

The port's copy of ``gofr_tpu/datasource/widecolumn/__init__.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Any

LOGGED_BATCH = 0
UNLOGGED_BATCH = 1


class CASError(RuntimeError):
    pass


class EmbeddedWideColumnStore:
    def __init__(self, path: str = ":memory:") -> None:
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        self._batches: dict[str, list[tuple[str, tuple]]] = {}
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "EmbeddedWideColumnStore":
        return cls(config.get_or_default("WIDECOLUMN_DB_PATH", ":memory:"))

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
            pass  # already registered

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        if self._logger:
            self._logger.info(f"wide-column store connected ({self.path})")

    def _observe(self, op: str) -> None:
        if self._metrics:
            self._metrics.record_histogram("app_cassandra_stats", 0.0, operation=op)

    # -- WideColumnStore contract ----------------------------------------------
    def query(self, target: Any, stmt: str, *values: Any) -> Any:
        """Run a SELECT; appends row dicts into ``target`` (list) and also
        returns them (the reference scans into a destination slice)."""
        self._observe("query")
        with self._lock:
            rows = self._conn.execute(stmt, values).fetchall()
        dicts = [dict(r) for r in rows]
        if isinstance(target, list):
            target.extend(dicts)
        return dicts

    def exec(self, stmt: str, *values: Any) -> None:
        self._observe("exec")
        with self._lock:
            self._conn.execute(stmt, values)
            self._conn.commit()

    def exec_cas(self, target: Any, stmt: str, *values: Any) -> bool:
        """Compare-and-set. ``INSERT ... IF NOT EXISTS`` applies only when
        the row is absent; ``UPDATE ... IF <cond>`` only when the condition
        holds. Returns ``applied`` like cassandra's CAS."""
        self._observe("exec_cas")
        upper = stmt.upper()
        with self._lock:
            if "IF NOT EXISTS" in upper and upper.lstrip().startswith("INSERT"):
                import re

                sql = _strip_clause(stmt, "IF NOT EXISTS")
                sql = re.sub(r"(?i)\binsert\b", "INSERT OR IGNORE", sql, count=1)
                cur = self._conn.execute(sql, values)
                self._conn.commit()
                return cur.rowcount > 0
            if upper.lstrip().startswith("UPDATE") and " IF " in upper:
                # UPDATE t SET a=? WHERE k=? IF b=?  →  append condition to WHERE
                head, _, cond = _rpartition_ci(stmt, " IF ")
                sql = f"{head} AND ({cond})" if " WHERE " in head.upper() else \
                    f"{head} WHERE {cond}"
                cur = self._conn.execute(sql, values)
                self._conn.commit()
                return cur.rowcount > 0
            cur = self._conn.execute(stmt, values)
            self._conn.commit()
            return cur.rowcount > 0

    def new_batch(self, name: str, batch_type: int = LOGGED_BATCH) -> None:
        with self._lock:
            self._batches[name] = []

    def batch_query(self, name: str, stmt: str, *values: Any) -> None:
        with self._lock:
            if name not in self._batches:
                raise KeyError(f"batch {name!r} not created")
            self._batches[name].append((stmt, values))

    def execute_batch(self, name: str) -> None:
        """All-or-nothing: one transaction (LoggedBatch atomicity)."""
        self._observe("execute_batch")
        with self._lock:
            stmts = self._batches.pop(name, None)
            if stmts is None:
                raise KeyError(f"batch {name!r} not created")
            try:
                for stmt, values in stmts:
                    self._conn.execute(stmt, values)
                self._conn.commit()
            except sqlite3.Error:
                self._conn.rollback()
                raise

    # -- health ----------------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._conn.execute("SELECT 1")
            return {
                "status": "UP",
                "details": {"backend": "embedded-widecolumn", "path": self.path},
            }
        except sqlite3.Error as exc:
            return {"status": "DOWN", "details": {"error": str(exc)}}

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def _strip_clause(stmt: str, clause: str) -> str:
    idx = stmt.upper().find(clause)
    return stmt[:idx] + stmt[idx + len(clause):]


def _rpartition_ci(stmt: str, sep: str) -> tuple[str, str, str]:
    idx = stmt.upper().rfind(sep)
    return stmt[:idx], sep, stmt[idx + len(sep):]


def new_widecolumn_store(config: Any):
    """Backend selection (reference: Cassandra is an external driver
    picked by config — container/datasources.go:42-194): CASSANDRA_HOST
    selects the wire driver (widecolumn/cassandra.py, real CQL binary
    protocol); otherwise the embedded zero-service engine."""
    if config.get("CASSANDRA_HOST"):
        from gofr_tpu_torch.datasource.widecolumn.cassandra import CassandraClient

        return CassandraClient.from_config(config)
    return EmbeddedWideColumnStore.from_config(config)
