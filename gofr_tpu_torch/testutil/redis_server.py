"""A small RESP2 server over the port's ``InMemoryRedis``, for tests.

Test infrastructure, not a feature of the framework: the framework's Redis
datasource is the client (``datasource/redis/client.py``); this fake gives
that client a socket to talk to where no Redis runs (a test host, the
card's machine). The JAX package has no such fake: it tests its client
over a socketpair.

It answers exactly the commands the client sends: ``AUTH``, ``SELECT``,
``GET``, ``SET key value [PX ms]``, ``DEL``, ``EXISTS``, ``INCR``,
``HSET``, ``HGET``, ``HGETALL``, ``PEXPIRE``, ``PTTL`` and ``PING``, with
Redis's replies (``PTTL`` -2 for a missing key, -1 for one without a TTL),
and anything else with ``-ERR unknown command``. With a password set, every
command but ``AUTH`` answers ``-NOAUTH`` until the connection has
authenticated. Each accepted socket sets ``TCP_NODELAY``, as the port's
other fakes do (ROADMAP Queue C 43). ``close()`` stops the listener and
drops every connection, as a Redis that went down.
"""

from __future__ import annotations

import socket
import threading
from typing import Any

from gofr_tpu_torch.datasource.redis.memory import InMemoryRedis


def _bulk(value: str | None) -> bytes:
    if value is None:
        return b"$-1\r\n"
    data = value.encode()
    return b"$%d\r\n%s\r\n" % (len(data), data)


def _int(n: int) -> bytes:
    return b":%d\r\n" % n


def _err(text: str) -> bytes:
    return f"-{text}\r\n".encode()


OK = b"+OK\r\n"

# command -> (least, most) arguments after the name; None for no upper bound
_ARITY: dict[str, tuple[int, int | None]] = {
    "AUTH": (1, 2), "SELECT": (1, 1), "GET": (1, 1), "SET": (2, 4), "DEL": (1, None),
    "EXISTS": (1, None), "INCR": (1, 1), "HSET": (3, 3), "HGET": (2, 2), "HGETALL": (1, 1),
    "PEXPIRE": (2, 2), "PTTL": (1, 1), "PING": (0, 1),
}


class MiniRedisServer:
    """RESP2 on 127.0.0.1 over one ``InMemoryRedis`` per database index
    (``store`` is database 0). ``commands`` counts every command served,
    by name."""

    def __init__(self, store: InMemoryRedis | None = None, port: int = 0,
                 password: str | None = None, username: str = "default") -> None:
        self.dbs: dict[int, InMemoryRedis] = {0: store if store is not None else InMemoryRedis()}
        self.password, self.username = password, username
        self.commands: dict[str, int] = {}
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._running = True
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(16)
        self.host, self.port = "127.0.0.1", self._server.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True, name="redis-server").start()

    @property
    def store(self) -> InMemoryRedis:
        return self.dbs[0]

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if not self._running:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="redis-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")
        state = {"db": 0, "authed": self.password is None}
        try:
            while True:
                parts = _read_command(f)
                if parts is None:
                    return
                conn.sendall(self._answer(parts, state))
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                f.close()
                conn.close()
            except OSError:
                pass

    def _answer(self, parts: list[str], state: dict) -> bytes:
        name, args = parts[0].upper(), parts[1:]
        with self._lock:
            self.commands[name] = self.commands.get(name, 0) + 1
        arity = _ARITY.get(name)
        if arity is None:
            return _err(f"ERR unknown command '{parts[0]}'")
        least, most = arity
        if len(args) < least or (most is not None and len(args) > most):
            return _err(f"ERR wrong number of arguments for '{parts[0].lower()}' command")
        if name == "AUTH":
            return self._auth(args, state)
        if not state["authed"]:
            return _err("NOAUTH Authentication required.")
        if name == "SELECT":
            try:
                index = int(args[0])
            except ValueError:
                return _err("ERR value is not an integer or out of range")
            with self._lock:
                self.dbs.setdefault(index, InMemoryRedis())
            state["db"] = index
            return OK
        return self._data_command(name, args, self.dbs[state["db"]])

    def _auth(self, args: list[str], state: dict) -> bytes:
        if self.password is None:
            return _err("ERR AUTH <password> called without any password configured "
                        "for the default user. Are you sure your configuration is correct?")
        user, password = (args[0], args[1]) if len(args) == 2 else ("default", args[0])
        if password != self.password or user not in ("default", self.username):
            return _err("WRONGPASS invalid username-password pair or user is disabled.")
        state["authed"] = True
        return OK

    @staticmethod
    def _data_command(name: str, args: list[str], db: InMemoryRedis) -> bytes:
        if name == "PING":
            return b"+PONG\r\n" if not args else _bulk(args[0])
        if name == "GET":
            return _bulk(db.get(args[0]))
        if name == "SET":
            ttl = None
            if len(args) == 4:
                if args[2].upper() != "PX":
                    return _err("ERR syntax error")
                try:
                    ttl = int(args[3]) / 1000.0
                except ValueError:
                    return _err("ERR value is not an integer or out of range")
            elif len(args) == 3:
                return _err("ERR syntax error")
            db.set(args[0], args[1], ttl)
            return OK
        if name == "DEL":
            return _int(db.delete(*args))
        if name == "EXISTS":
            return _int(db.exists(*args))
        if name == "INCR":
            try:
                return _int(db.incr(args[0]))
            except ValueError:
                return _err("ERR value is not an integer or out of range")
        if name == "HSET":
            return _int(db.hset(args[0], args[1], args[2]))
        if name == "HGET":
            return _bulk(db.hget(args[0], args[1]))
        if name == "HGETALL":
            flat = [x for kv in db.hgetall(args[0]).items() for x in kv]
            return b"*%d\r\n" % len(flat) + b"".join(_bulk(x) for x in flat)
        if name == "PEXPIRE":
            try:
                ms = int(args[1])
            except ValueError:
                return _err("ERR value is not an integer or out of range")
            return _int(1 if db.expire(args[0], ms / 1000.0) else 0)
        # PTTL
        if not db.exists(args[0]):
            return _int(-2)
        ttl = db.ttl(args[0])
        return _int(-1 if ttl < 0 else int(ttl * 1000))


def _read_command(f: Any) -> list[str] | None:
    """One RESP2 array of bulk strings, or None at the end of the stream."""
    line = f.readline()
    if not line:
        return None
    if not line.startswith(b"*"):
        raise ValueError(f"expected a RESP array, got {line[:16]!r}")
    parts = []
    for _ in range(int(line[1:-2])):
        head = f.readline()
        if not head.startswith(b"$"):
            raise ValueError(f"expected a bulk string, got {head[:16]!r}")
        data = f.read(int(head[1:-2]) + 2)
        parts.append(data[:-2].decode("utf-8", "replace"))
    return parts
