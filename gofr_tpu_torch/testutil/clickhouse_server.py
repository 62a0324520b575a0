"""In-process ClickHouse-HTTP-interface server for tests, backed by
sqlite (SURVEY §4 tier 4 stand-in, like postgres_server.py).

Serves the interface subset the columnar driver uses: ``POST /?query=``
with ``FORMAT JSONEachRow`` output, ``param_<name>`` server-side binding
substituted into ``{name:Type}`` placeholders, JSONEachRow INSERT
bodies, X-ClickHouse-User/Key auth, async_insert settings accepted (and
applied synchronously — the observable contract), ClickHouse-style
exception text with HTTP 4xx/5xx on bad SQL.

The port's copy of ``gofr_tpu/testutil/clickhouse_server.py``; it imports
nothing of the JAX package. One difference, not a byte on the wire: each
accepted socket sets ``TCP_NODELAY``, as the port's other fakes do (ROADMAP
Queue C 43 and 50).
"""

from __future__ import annotations

import json
import re
import socket
import sqlite3
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

_PLACEHOLDER = re.compile(r"\{(\w+):[^}]+\}")


class _NoDelayServer(ThreadingHTTPServer):
    def get_request(self) -> tuple[socket.socket, Any]:
        sock, addr = super().get_request()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock, addr


class MiniClickHouseServer:
    def __init__(self, port: int = 0, user: str = "default",
                 password: str = "") -> None:
        self.user, self.password = user, password
        self._db = sqlite3.connect(":memory:", check_same_thread=False)
        self._db.row_factory = sqlite3.Row
        self._db.isolation_level = None
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: Any) -> None:
                pass

            def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
                outer._handle(self)

            def do_GET(self) -> None:  # noqa: N802
                outer._handle(self)

        self._server = _NoDelayServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="clickhouse-server").start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- request handling --------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urllib.parse.urlparse(req.path)
        qs = dict(urllib.parse.parse_qsl(parsed.query))
        user = req.headers.get("X-ClickHouse-User", "default")
        key = req.headers.get("X-ClickHouse-Key", "")
        if user != self.user or key != self.password:
            self._reply(req, 403, "Code: 516. Authentication failed")
            return
        query = qs.get("query", "").strip()
        length = int(req.headers.get("Content-Length") or 0)
        body = req.rfile.read(length) if length else b""
        params = {
            k[len("param_"):]: v for k, v in qs.items() if k.startswith("param_")
        }
        try:
            out = self._execute(query, params, body)
        except sqlite3.Error as exc:
            self._reply(req, 400, f"Code: 62. DB::Exception: {exc}")
            return
        except ValueError as exc:
            self._reply(req, 400, f"Code: 36. DB::Exception: {exc}")
            return
        self._reply(req, 200, out)

    def _reply(self, req: BaseHTTPRequestHandler, status: int, text: str) -> None:
        data = text.encode()
        req.send_response(status)
        req.send_header("Content-Type", "text/plain; charset=UTF-8")
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    # -- query execution ---------------------------------------------------
    def _execute(self, query: str, params: dict[str, str], body: bytes) -> str:
        fmt_json = False
        m = re.search(r"\sFORMAT\s+(\w+)\s*$", query, re.IGNORECASE)
        if m:
            fmt = m.group(1).upper()
            query = query[: m.start()].strip()
            if fmt == "JSONEACHROW":
                fmt_json = True
            elif fmt not in ("TABSEPARATED", "TSV"):
                raise ValueError(f"unsupported FORMAT {fmt}")

        if query.upper().startswith("INSERT INTO") and body:
            return self._insert_json_rows(query, body)

        # {name:Type} → ? with ordered params
        ordered: list[str] = []

        def sub(match: "re.Match[str]") -> str:
            name = match.group(1)
            if name not in params:
                raise ValueError(f"missing query parameter {name!r}")
            ordered.append(params[name])
            return "?"

        sqlite_sql = _PLACEHOLDER.sub(sub, query)
        sqlite_sql = sqlite_sql.replace("version()", "'23.8-gofr-mini'")
        with self._lock:
            cur = self._db.execute(sqlite_sql, ordered)
            rows = cur.fetchall() if cur.description else []
        if not cur.description:
            return ""
        if fmt_json:
            return "\n".join(json.dumps(dict(r)) for r in rows) + ("\n" if rows else "")
        return "\n".join("\t".join(str(v) for v in tuple(r)) for r in rows)

    def _insert_json_rows(self, query: str, body: bytes) -> str:
        m = re.match(r"INSERT\s+INTO\s+([\w.]+)", query, re.IGNORECASE)
        if not m:
            raise ValueError("malformed INSERT")
        table = m.group(1)
        rows = [json.loads(line) for line in body.decode().splitlines() if line.strip()]
        if not rows:
            return ""
        cols = sorted({k for r in rows for k in r})
        with self._lock:
            self._db.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                f"({', '.join(c for c in cols)})"
            )
            for r in rows:
                names = sorted(r)
                self._db.execute(
                    f"INSERT INTO {table} ({', '.join(names)}) "
                    f"VALUES ({', '.join('?' for _ in names)})",
                    [r[n] for n in names],
                )
        return ""

    # -- test inspection ---------------------------------------------------
    def rows(self, sql: str) -> list[tuple]:
        with self._lock:
            return [tuple(r) for r in self._db.execute(sql).fetchall()]


def start_clickhouse_server(**kw: Any) -> MiniClickHouseServer:
    return MiniClickHouseServer(**kw)
