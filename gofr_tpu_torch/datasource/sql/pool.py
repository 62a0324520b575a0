"""SQL connection pool + keepalive reconnect loop.

Reference parity: pkg/gofr/datasource/sql/sql.go — database/sql's pool
(sql.go:92-137) with the conn-pool gauge goroutine (sql.go:239-252:
``app_sql_open_connections`` / ``app_sql_in_use_connections``) and the
10 s ping-retry reconnect loop (sql.go:151-174) that keeps trying to
re-establish a dead database connection and logs each failed attempt.

The pool is dialect-agnostic: Postgres and MySQL connections plug in via
three duck-typed methods — ``ping()`` (raise on dead), ``close()``, and
whatever execute surface the dialect facade uses while holding a
connection it acquired.

The port's copy of ``gofr_tpu/datasource/sql/pool.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable


class PoolTimeout(ConnectionError):
    """No connection became available within the checkout timeout."""


class ConnectionPool:
    def __init__(
        self,
        dial: Callable[[], Any],
        *,
        max_open: int = 4,
        checkout_timeout: float = 30.0,
        ping_interval: float = 10.0,
        dialect: str = "sql",
        logger: Any = None,
        metrics: Any = None,
    ) -> None:
        self._dial = dial
        self.max_open = max(1, max_open)
        self.checkout_timeout = checkout_timeout
        self.ping_interval = ping_interval
        self.dialect = dialect
        self._logger = logger
        self._metrics = metrics
        self._idle: list[Any] = []
        self._open = 0  # idle + in-use
        self._cond = threading.Condition()
        self._closed = False
        self._stop_ev = threading.Event()  # interrupts the ping-loop wait
        self._ping_thread: threading.Thread | None = None

    # observability hooks are wired after construction by the provider
    # pattern (use_logger/use_metrics on the dialect facade)
    def set_observers(self, logger: Any, metrics: Any) -> None:
        self._logger = logger
        self._metrics = metrics

    # -- checkout/checkin --------------------------------------------------
    def acquire(self, timeout: float | None = None) -> Any:
        """A live connection: idle one if available, a fresh dial while
        below ``max_open``, else wait until one is released."""
        deadline = time.monotonic() + (
            self.checkout_timeout if timeout is None else timeout
        )
        with self._cond:
            while True:
                if self._closed:
                    raise ConnectionError("pool closed")
                while self._idle:
                    conn = self._idle.pop()
                    # liveness check on reuse (go-sql-driver connCheck
                    # model): a socket the server closed while idle is
                    # detected HERE, before any statement is sent — so no
                    # statement ever needs a could-have-executed retry
                    if getattr(conn, "is_stale", None) and conn.is_stale():
                        self._open -= 1
                        try:
                            conn.close()
                        except Exception:
                            pass
                        continue
                    self._publish_gauges()
                    return conn
                if self._open < self.max_open:
                    self._open += 1  # reserve the slot before dialing
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PoolTimeout(
                        f"{self.dialect} pool exhausted: {self.max_open} "
                        f"connection(s) busy for >{self.checkout_timeout}s"
                    )
                self._cond.wait(timeout=remaining)
        try:
            conn = self._dial()
        except BaseException:
            with self._cond:
                self._open -= 1
                self._cond.notify()
            raise
        self._publish_gauges()
        return conn

    def release(self, conn: Any, *, broken: bool = False) -> None:
        with self._cond:
            if broken or self._closed:
                self._open -= 1
                try:
                    conn.close()
                except Exception:
                    pass
            else:
                self._idle.append(conn)
            self._cond.notify()
        self._publish_gauges()

    def try_acquire_idle(self) -> Any | None:
        """An idle connection without dialing or waiting (ping loop)."""
        with self._cond:
            if self._idle:
                conn = self._idle.pop()
                self._publish_gauges()
                return conn
        return None

    # -- keepalive ---------------------------------------------------------
    def start_ping_loop(self) -> None:
        """sql.go:151-174: a background loop that pings an idle connection
        every ``ping_interval`` seconds and — when the database is down —
        keeps retrying the dial so the pool self-heals without waiting
        for the next request."""
        if self._ping_thread is not None:
            return
        self._ping_thread = threading.Thread(
            target=self._ping_loop, daemon=True, name=f"{self.dialect}-pool-ping"
        )
        self._ping_thread.start()

    def _ping_loop(self) -> None:
        while not self._closed:
            if self._stop_ev.wait(self.ping_interval):
                return  # close_all() interrupted the wait
            if self._closed:
                return
            self._ping_once()

    def _ping_once(self) -> None:
        conn = self.try_acquire_idle()
        if conn is not None:
            try:
                conn.ping()
                self.release(conn)
                return
            except Exception as exc:
                self.release(conn, broken=True)
                if self._logger:
                    self._logger.warn(
                        f"{self.dialect} keepalive ping failed: {exc}; redialing"
                    )
        # nothing idle & alive: try to (re)establish one connection so the
        # pool recovers while the app is quiet
        with self._cond:
            if self._closed or self._open >= self.max_open:
                return
            self._open += 1
        try:
            conn = self._dial()
        except Exception as exc:
            with self._cond:
                self._open -= 1
                self._cond.notify()
            if self._logger:
                self._logger.error(
                    f"{self.dialect} reconnect attempt failed: {exc}; "
                    f"retrying in {self.ping_interval:.0f}s"
                )
            return
        self.release(conn)
        if self._logger:
            self._logger.info(f"{self.dialect} connection re-established")

    # -- lifecycle ---------------------------------------------------------
    def stats(self) -> dict[str, int]:
        with self._cond:
            return {
                "open": self._open,
                "idle": len(self._idle),
                "in_use": self._open - len(self._idle),
                "max_open": self.max_open,
            }

    def _publish_gauges(self) -> None:
        if not self._metrics:
            return
        s = self.stats()
        self._metrics.set_gauge("app_sql_open_connections", s["open"],
                                dialect=self.dialect)
        self._metrics.set_gauge("app_sql_inuse_connections", s["in_use"],
                                dialect=self.dialect)

    def close_all(self) -> None:
        self._stop_ev.set()
        with self._cond:
            self._closed = True
            idle, self._idle = self._idle, []
            self._open -= len(idle)
            self._cond.notify_all()
        for conn in idle:
            try:
                conn.close()
            except Exception:
                pass
        self._publish_gauges()
