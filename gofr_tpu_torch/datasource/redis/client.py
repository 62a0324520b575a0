"""RESP2 socket client — the real Redis driver.

Reference parity: datasource/redis/redis.go (go-redis v9 + TLS, REDIS_HOST /
REDIS_PORT / REDIS_USER / REDIS_PASSWORD / REDIS_DB config) and redis/hook.go
(per-command QUERY log + ``app_redis_stats`` histogram). The wire protocol is
implemented directly (RESP2 framing) since the image carries no redis lib.

The port's copy of ``gofr_tpu/datasource/redis/client.py``; it imports nothing of the JAX package.
One addition: with a tracer set (``use_tracer``), each command runs in a
client span ``redis <command>``, as the reference's tracing hook opens one
(redis.go:60-64); the JAX package's client keeps the tracer unused.
"""

from __future__ import annotations

import contextlib
import io
import socket
import ssl as ssl_module
import threading
import time
from typing import Any


class RedisError(Exception):
    pass


class RedisLog:
    def __init__(self, command: str, duration_us: int) -> None:
        self.command = command
        self.duration = duration_us

    def pretty_print(self, writer: io.TextIOBase) -> None:
        writer.write(f"\x1b[38;5;8mREDIS\x1b[0m {self.duration:>8}µs {self.command}")

    def __str__(self) -> str:
        return f"REDIS {self.duration}µs {self.command}"


def _encode(parts: list[Any]) -> bytes:
    out = [f"*{len(parts)}\r\n".encode()]
    for p in parts:
        b = p if isinstance(p, bytes) else str(p).encode()
        out.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
    return b"".join(out)


class RedisClient:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 6379,
        username: str | None = None,
        password: str | None = None,
        db: int = 0,
        use_tls: bool = False,
        timeout: float = 5.0,
    ) -> None:
        self.host, self.port = host, port
        self._address = f"{host}:{port}"  # one bounded label value per client
        self.username, self.password, self.db = username, password, db
        self.use_tls = use_tls
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._file: Any = None
        self._lock = threading.Lock()
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "RedisClient":
        return cls(
            host=config.get_or_default("REDIS_HOST", "localhost"),
            port=int(config.get_or_default("REDIS_PORT", "6379")),
            username=config.get("REDIS_USER"),
            password=config.get("REDIS_PASSWORD"),
            db=int(config.get_or_default("REDIS_DB", "0")),
            use_tls=config.get_or_default("REDIS_TLS_ENABLED", "false").lower() == "true",
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        try:
            self._connect_socket()
            if self._logger:
                self._logger.info(f"connected to redis at {self.host}:{self.port}")
        except Exception as exc:
            # like the reference, a down Redis does not abort app startup;
            # health reports DOWN and commands error (redis.go connect logs)
            if self._logger:
                self._logger.error(f"could not connect to redis at {self.host}:{self.port}: {exc}")

    def _connect_socket(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
        if self.use_tls:
            ctx = ssl_module.create_default_context()
            sock = ctx.wrap_socket(sock, server_hostname=self.host)
        self._sock = sock
        self._file = sock.makefile("rb")
        if self.password:
            if self.username:
                self._command_raw("AUTH", self.username, self.password)
            else:
                self._command_raw("AUTH", self.password)
        if self.db:
            self._command_raw("SELECT", self.db)

    def _read_reply(self) -> Any:
        line = self._file.readline()
        if not line:
            raise RedisError("connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._file.read(n + 2)[:-2]
            return data.decode("utf-8", "replace")
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RedisError(f"bad RESP type byte: {kind!r}")

    def _command_raw(self, *parts: Any) -> Any:
        if self._sock is None:
            self._connect_socket()
        self._sock.sendall(_encode(list(parts)))
        return self._read_reply()

    def command(self, *parts: Any) -> Any:
        start = time.perf_counter()
        with self._span(str(parts[0]).lower()), self._lock:
            try:
                reply = self._command_raw(*parts)
            except (OSError, RedisError):
                # one reconnect attempt, then surface the error
                self._teardown()
                self._connect_socket()
                reply = self._command_raw(*parts)
        duration_us = int((time.perf_counter() - start) * 1e6)
        if self._logger:
            self._logger.debug(RedisLog(str(parts[0]), duration_us))
        if self._metrics:
            self._metrics.record_histogram(
                "app_redis_stats", duration_us / 1000.0,
                hostname=self._address, type=str(parts[0]).lower(),
            )
        return reply

    def _span(self, command: str):
        """A client span per command (redis.go:60-64), when a tracer is set;
        a failed command ends it with the error recorded."""
        if self._tracer is None:
            return contextlib.nullcontext()
        span = self._tracer.start_span(f"redis {command}", kind="client")
        span.set_attribute("db.system", "redis")
        span.set_attribute("server.address", self._address)
        return span

    # -- Redis contract --------------------------------------------------------
    def get(self, key: str) -> str | None:
        return self.command("GET", key)

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> bool:
        if ttl_seconds is not None:
            reply = self.command("SET", key, value, "PX", int(ttl_seconds * 1000))
        else:
            reply = self.command("SET", key, value)
        return reply == "OK"

    def delete(self, *keys: str) -> int:
        return int(self.command("DEL", *keys))

    def exists(self, *keys: str) -> int:
        return int(self.command("EXISTS", *keys))

    def incr(self, key: str) -> int:
        return int(self.command("INCR", key))

    def hset(self, key: str, field: str, value: Any) -> int:
        return int(self.command("HSET", key, field, value))

    def hget(self, key: str, field: str) -> str | None:
        return self.command("HGET", key, field)

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self.command("HGETALL", key) or []
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    def expire(self, key: str, ttl_seconds: float) -> bool:
        return int(self.command("PEXPIRE", key, int(ttl_seconds * 1000))) == 1

    def ttl(self, key: str) -> float:
        return int(self.command("PTTL", key)) / 1000.0

    def ping(self) -> bool:
        try:
            return self.command("PING") == "PONG"
        except (OSError, RedisError):
            return False

    def _teardown(self) -> None:
        try:
            if self._file:
                self._file.close()
            if self._sock:
                self._sock.close()
        except OSError:
            pass
        self._sock, self._file = None, None

    def close(self) -> None:
        with self._lock:
            self._teardown()

    def health_check(self) -> dict[str, Any]:
        host = f"{self.host}:{self.port}"
        if self.ping():
            return {"status": "UP", "details": {"host": host}}
        return {"status": "DOWN", "details": {"host": host, "error": "ping failed"}}


def new_redis(config: Any) -> RedisClient:
    return RedisClient.from_config(config)
