"""Columnar datasource — the ClickHouse-shaped contract
(container/datasources.go:196-208) over the ClickHouse HTTP interface.

The reference interface is ``Select(ctx, dest, query, args...)`` /
``Exec`` / ``AsyncInsert`` via clickhouse-go; this driver speaks the
HTTP interface every ClickHouse deployment exposes (``POST /?query=``,
``JSONEachRow`` format, ``async_insert=1``) using the framework's own
HTTP client stack — works against a real ClickHouse or the in-process
mini server (testutil/clickhouse_server.py). Parameterized queries use
ClickHouse's server-side binding (``{name:Type}`` + ``param_<name>``),
so values never concatenate into SQL.

The port's copy of ``gofr_tpu/datasource/columnar/__init__.py``; it imports
nothing of the JAX package, and sends the same bytes.
"""

from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from gofr_tpu_torch.datasource.sql.sqlite import bind_rows


class ColumnarError(Exception):
    status_code = 500

    def __init__(self, message: str, http_status: int = 500) -> None:
        super().__init__(message)
        self.http_status = http_status


class ClickHouseClient:
    dialect = "clickhouse"

    def __init__(self, url: str = "http://localhost:8123",
                 user: str = "default", password: str = "",
                 database: str = "default", timeout: float = 10.0) -> None:
        self.url = url.rstrip("/")
        self.user, self.password = user, password
        self.database = database
        self.timeout = timeout
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "ClickHouseClient":
        return cls(
            url=config.get_or_default("CLICKHOUSE_URL", "http://localhost:8123"),
            user=config.get_or_default("CLICKHOUSE_USER", "default"),
            password=config.get_or_default("CLICKHOUSE_PASSWORD", ""),
            database=config.get_or_default("CLICKHOUSE_DATABASE", "default"),
        )

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        self._http("SELECT 1")
        if self._logger:
            self._logger.debug(f"clickhouse connected at {self.url}")

    # -- http --------------------------------------------------------------
    def _http(self, query: str, params: dict[str, Any] | None = None,
              body: bytes = b"", settings: dict[str, str] | None = None) -> str:
        qs: dict[str, str] = {"query": query, "database": self.database}
        for k, v in (settings or {}).items():
            qs[k] = v
        for name, value in (params or {}).items():
            qs[f"param_{name}"] = _param_text(value)
        url = f"{self.url}/?{urllib.parse.urlencode(qs)}"
        req = urllib.request.Request(url, data=body or None, method="POST")
        req.add_header("X-ClickHouse-User", self.user)
        if self.password:
            req.add_header("X-ClickHouse-Key", self.password)
        start = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = resp.read().decode()
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:500]
            raise ColumnarError(detail or str(exc), exc.code) from exc
        except urllib.error.URLError as exc:
            raise ColumnarError(str(exc.reason)) from exc
        if self._metrics:
            self._metrics.record_histogram(
                "app_sql_stats", (time.perf_counter() - start) * 1000,
                hostname=self.url, database=self.dialect,
            )
        return out

    # -- ClickHouse contract (datasources.go:196-208) ----------------------
    def select(self, dest: Any, query: str, params: dict[str, Any] | None = None) -> Any:
        """Rows as dicts (FORMAT JSONEachRow) bound into ``dest`` like the
        SQL family's select. The driver owns the FORMAT clause — a query
        supplying its own (or a trailing ``;``) would double the clause on
        a real server."""
        query = query.rstrip().rstrip(";").rstrip()
        if re.search(r"\sFORMAT\s+\w+$", query, re.IGNORECASE):
            raise ColumnarError(
                "select() appends FORMAT JSONEachRow itself; drop the "
                "FORMAT clause from the query", 400,
            )
        text = self._http(query + " FORMAT JSONEachRow", params)
        rows = [json.loads(line) for line in text.splitlines() if line.strip()]
        return bind_rows(rows, dest)

    def exec(self, query: str, params: dict[str, Any] | None = None) -> None:
        self._http(query, params)

    def async_insert(self, query: str, params: dict[str, Any] | None = None) -> None:
        """AsyncInsert: the server buffers and flushes out-of-band
        (async_insert=1, no wait)."""
        self._http(query, params, settings={
            "async_insert": "1", "wait_for_async_insert": "0",
        })

    def insert_rows(self, table: str, rows: list[dict[str, Any]]) -> None:
        """Bulk JSONEachRow ingestion — the columnar hot path."""
        body = "\n".join(json.dumps(r) for r in rows).encode()
        self._http(f"INSERT INTO {table} FORMAT JSONEachRow", body=body)

    # -- health ------------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            version = self.select(dict, "SELECT version() AS v")
            return {
                "status": "UP",
                "details": {
                    "backend": "clickhouse",
                    "url": self.url,
                    "database": self.database,
                    "version": version[0]["v"] if version else "unknown",
                },
            }
        except Exception as exc:
            return {
                "status": "DOWN",
                "details": {"backend": "clickhouse", "url": self.url,
                            "error": str(exc)},
            }

    def close(self) -> None:
        pass  # stateless HTTP


def _param_text(value: Any) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    return str(value)
