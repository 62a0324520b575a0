"""In-process Solr-HTTP server for tests, adapting the embedded BM25
engine (datasource/search) behind the Solr wire (SURVEY §4 tier 4).

Serves the surface the Solr driver uses: ``/solr/admin/collections``
(CREATE/DELETE/LIST), ``/solr/<c>/select`` with a standard-query-parser
subset (``*:*``, ``field:value``, ``field:[a TO b]`` ranges, free text
→ BM25 match over all fields, ``AND``/``OR`` pairs), and
``/solr/<c>/update`` JSON commands (add array, delete by ids or query).
Responses use Solr's standard envelope.

The port's copy of ``gofr_tpu/testutil/solr_server.py``; it imports nothing of the JAX package.
One difference, not a byte on the wire: ``commands`` counts the requests
served, by endpoint (``select``, ``update``, and ``admin:<ACTION>``).
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from gofr_tpu_torch.datasource.search import EmbeddedSearch, IndexNotFound, SearchError

_RANGE = re.compile(r"^(\w+):\[(\S+)\s+TO\s+(\S+)\]$")
_FIELD = re.compile(r"^(\w+):(.+)$")


def _term(value: str) -> Any:
    value = value.strip().strip('"')
    try:
        return int(value)
    except ValueError:
        try:
            return float(value)
        except ValueError:
            return value


def _bound(value: str) -> Any:
    return None if value == "*" else _term(value)


def solr_q_to_query(q: str) -> dict:
    """Standard-query-parser subset → the embedded engine's query DSL."""
    q = q.strip()
    if not q or q == "*:*":
        return {"match_all": {}}
    for joiner, key in ((" AND ", "must"), (" OR ", "should")):
        if joiner in q:
            parts = [solr_q_to_query(p) for p in q.split(joiner)]
            return {"bool": {key: parts}}
    m = _RANGE.match(q)
    if m:
        field, lo, hi = m.groups()
        bounds: dict[str, Any] = {}
        if _bound(lo) is not None:
            bounds["gte"] = _bound(lo)
        if _bound(hi) is not None:
            bounds["lte"] = _bound(hi)
        return {"range": {field: bounds}}
    m = _FIELD.match(q)
    if m:
        field, value = m.groups()
        term = _term(value)
        if isinstance(term, str) and " " in term:
            return {"match": {field: term}}
        return {"term": {field: term}}
    return {"match": {"_all": q}}


class MiniSolrServer:
    def __init__(self, port: int = 0) -> None:
        self._engine = EmbeddedSearch()
        self._lock = threading.Lock()
        self.commands: dict[str, int] = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: Any) -> None:
                pass

            def do_GET(self) -> None:  # noqa: N802
                outer._handle(self, b"")

            def do_POST(self) -> None:  # noqa: N802
                length = int(self.headers.get("Content-Length") or 0)
                outer._handle(self, self.rfile.read(length) if length else b"")

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="solr-server").start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- plumbing ----------------------------------------------------------
    def _reply(self, req: BaseHTTPRequestHandler, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        req.send_response(status)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _error(self, req: BaseHTTPRequestHandler, status: int, msg: str) -> None:
        self._reply(req, status, {"error": {"code": status, "msg": msg}})

    def _handle(self, req: BaseHTTPRequestHandler, body: bytes) -> None:
        parsed = urllib.parse.urlparse(req.path)
        qs = dict(urllib.parse.parse_qsl(parsed.query))
        parts = [p for p in parsed.path.split("/") if p]
        name = (f"admin:{qs.get('action', '').upper()}" if parts[1:2] == ["admin"]
                else parts[-1] if parts else "")
        with self._lock:
            self.commands[name] = self.commands.get(name, 0) + 1
        try:
            if parts[:3] == ["solr", "admin", "collections"]:
                self._admin(req, qs)
            elif len(parts) == 3 and parts[0] == "solr" and parts[2] == "select":
                self._select(req, parts[1], qs)
            elif len(parts) == 3 and parts[0] == "solr" and parts[2] == "update":
                self._update(req, parts[1], body)
            else:
                self._error(req, 404, f"unknown path {parsed.path}")
        except IndexNotFound as exc:
            self._error(req, 404, f"Collection not found: {exc}")
        except (SearchError, ValueError) as exc:
            self._error(req, 400, str(exc))

    # -- endpoints ---------------------------------------------------------
    def _admin(self, req: BaseHTTPRequestHandler, qs: dict[str, str]) -> None:
        action = qs.get("action", "").upper()
        with self._lock:
            if action == "CREATE":
                self._engine.create_index(qs["name"])
                self._reply(req, 200, {"responseHeader": {"status": 0}})
            elif action == "DELETE":
                self._engine.delete_index(qs["name"])
                self._reply(req, 200, {"responseHeader": {"status": 0}})
            elif action == "LIST":
                self._reply(req, 200, {
                    "responseHeader": {"status": 0},
                    "collections": self._engine.indices(),
                })
            else:
                self._error(req, 400, f"unsupported action {action!r}")

    def _select(self, req: BaseHTTPRequestHandler, collection: str,
                qs: dict[str, str]) -> None:
        query = solr_q_to_query(qs.get("q", "*:*"))
        rows = int(qs.get("rows", "10"))
        start = int(qs.get("start", "0"))
        with self._lock:
            # sort applies to the FULL result set before start/rows (real
            # Solr semantics), so fetch everything when sorting
            size = 1_000_000 if qs.get("sort") else start + rows
            result = self._engine.search(collection, {"query": query}, size=size)
        docs = []
        for h in result["hits"]["hits"]:
            doc = dict(h["_source"])
            doc.setdefault("id", h["_id"])
            docs.append(doc)
        if qs.get("sort"):
            field, _, direction = qs["sort"].partition(" ")
            docs.sort(key=lambda d: d.get(field) or 0,
                      reverse=direction.strip() == "desc")
        docs = docs[start : start + rows]
        self._reply(req, 200, {
            "responseHeader": {"status": 0},
            "response": {
                "numFound": result["hits"]["total"]["value"],
                "start": start,
                "docs": docs,
            },
        })

    def _update(self, req: BaseHTTPRequestHandler, collection: str,
                body: bytes) -> None:
        payload = json.loads(body.decode() or "null")
        with self._lock:
            if collection not in self._engine.indices():
                self._engine.create_index(collection)
            if isinstance(payload, list):  # add/upsert documents
                for doc in payload:
                    if "id" not in doc:
                        raise ValueError("document missing required field: id")
                    self._engine.index_document(collection, str(doc["id"]), doc)
            elif isinstance(payload, dict) and "delete" in payload:
                spec = payload["delete"]
                if isinstance(spec, list):
                    for doc_id in spec:
                        try:
                            self._engine.delete_document(collection, str(doc_id))
                        except SearchError:
                            pass  # delete is idempotent in Solr
                elif isinstance(spec, dict) and "query" in spec:
                    query = solr_q_to_query(spec["query"])
                    result = self._engine.search(
                        collection, {"query": query}, size=1_000_000
                    )
                    for h in result["hits"]["hits"]:
                        self._engine.delete_document(collection, h["_id"])
                else:
                    raise ValueError("malformed delete command")
            else:
                raise ValueError("unsupported update payload")
        self._reply(req, 200, {"responseHeader": {"status": 0}})


def start_solr_server(**kw: Any) -> MiniSolrServer:
    return MiniSolrServer(**kw)
