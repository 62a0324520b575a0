"""Solr driver — the Solr-shaped contract (container/datasources.go:
386-406) over Solr's standard HTTP API.

The reference interface (Search/Create/Add/Update/Delete per collection)
wraps a Solr HTTP client; this driver speaks the same REST surface —
``/solr/<collection>/select`` with standard-query-parser ``q``,
``/solr/<collection>/update`` JSON commands (add docs, delete by id or
query, commit), ``/solr/admin/collections`` CREATE/DELETE — against a
real Solr or the in-process mini server (testutil/solr_server.py, which
adapts the embedded BM25 engine behind the Solr wire).

The port's copy of ``gofr_tpu/datasource/search/solr.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any


class SolrError(Exception):
    status_code = 500

    def __init__(self, message: str, http_status: int = 500) -> None:
        super().__init__(message)
        self.http_status = http_status


class SolrClient:
    def __init__(self, url: str = "http://localhost:8983",
                 timeout: float = 10.0) -> None:
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "SolrClient":
        return cls(url=config.get_or_default("SOLR_URL", "http://localhost:8983"))

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        self._get("/solr/admin/collections", {"action": "LIST"})
        if self._logger:
            self._logger.debug(f"solr connected at {self.url}")

    # -- http --------------------------------------------------------------
    def _request(self, method: str, path: str, qs: dict[str, str] | None = None,
                 body: Any = None) -> dict:
        url = self.url + path
        if qs:
            url += "?" + urllib.parse.urlencode({**qs, "wt": "json"})
        else:
            url += "?wt=json"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")
            try:
                detail = json.loads(detail).get("error", {}).get("msg", detail)
            except ValueError:
                pass
            raise SolrError(str(detail)[:500], exc.code) from exc
        except urllib.error.URLError as exc:
            raise SolrError(str(exc.reason)) from exc

    def _get(self, path: str, qs: dict[str, str] | None = None) -> dict:
        return self._request("GET", path, qs)

    # -- Solr contract (datasources.go:386-406) ----------------------------
    def search(self, collection: str, q: str = "*:*", *,
               rows: int = 10, start: int = 0, sort: str = "",
               fl: str = "") -> dict:
        """/select with the standard query parser; returns the standard
        ``{"response": {"numFound", "docs": [...]}}`` body."""
        qs = {"q": q, "rows": str(rows), "start": str(start)}
        if sort:
            qs["sort"] = sort
        if fl:
            qs["fl"] = fl
        return self._get(f"/solr/{collection}/select", qs)

    def add(self, collection: str, documents: list[dict], commit: bool = True) -> None:
        """Index documents (each needs an ``id``)."""
        self._request(
            "POST", f"/solr/{collection}/update",
            {"commit": "true"} if commit else {}, documents,
        )

    def update(self, collection: str, documents: list[dict], commit: bool = True) -> None:
        """Solr add IS upsert by id — aliased for the reference's Update."""
        self.add(collection, documents, commit)

    def delete_by_id(self, collection: str, ids: list[str], commit: bool = True) -> None:
        self._request(
            "POST", f"/solr/{collection}/update",
            {"commit": "true"} if commit else {},
            {"delete": [str(i) for i in ids]},
        )

    def delete_by_query(self, collection: str, query: str, commit: bool = True) -> None:
        self._request(
            "POST", f"/solr/{collection}/update",
            {"commit": "true"} if commit else {},
            {"delete": {"query": query}},
        )

    # -- collections admin -------------------------------------------------
    def create_collection(self, name: str) -> None:
        self._get("/solr/admin/collections", {"action": "CREATE", "name": name})

    def delete_collection(self, name: str) -> None:
        self._get("/solr/admin/collections", {"action": "DELETE", "name": name})

    def list_collections(self) -> list[str]:
        return self._get("/solr/admin/collections", {"action": "LIST"}).get(
            "collections", []
        )

    # -- health ------------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            collections = self.list_collections()
            return {
                "status": "UP",
                "details": {
                    "backend": "solr",
                    "url": self.url,
                    "collections": len(collections),
                },
            }
        except Exception as exc:
            return {
                "status": "DOWN",
                "details": {"backend": "solr", "url": self.url, "error": str(exc)},
            }

    def close(self) -> None:
        pass  # stateless HTTP
