"""Search datasource — the Elasticsearch-shaped contract
(container/datasources.go:708-746) with an embedded backend.

The reference interface is CreateIndex/DeleteIndex/IndexDocument/
GetDocument/UpdateDocument/DeleteDocument/Search/Bulk against a vendor
SDK; here the same surface runs on an in-process **inverted index with
BM25 ranking** (k1=1.2, b=0.75): per-index token postings with term
frequencies and document lengths, so `search` does real relevance
scoring, not a list scan. Query DSL subset: ``match`` (analyzed,
OR-of-terms), ``term`` (exact keyword on a field), ``range``
(gt/gte/lt/lte on numeric fields), ``bool`` (must/should/must_not),
``match_all`` — enough to serve the reference's documented examples.
Provider pattern + health like every other family.

The port's copy of ``gofr_tpu/datasource/search/__init__.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any

_TOKEN = re.compile(r"[a-z0-9]+")


def analyze(text: Any) -> list[str]:
    """Lowercase alnum tokenizer (the ES ``standard`` analyzer's core)."""
    return _TOKEN.findall(str(text).lower())


class SearchError(Exception):
    status_code = 500


class IndexNotFound(SearchError):
    status_code = 404


class _Index:
    def __init__(self, name: str, settings: dict | None = None) -> None:
        self.name = name
        self.settings = settings or {}
        self.docs: dict[str, dict] = {}
        # token → {doc_id → term_frequency}
        self.postings: dict[str, dict[str, int]] = {}
        self.doc_len: dict[str, int] = {}

    # -- indexing ----------------------------------------------------------
    def put(self, doc_id: str, doc: dict) -> None:
        if doc_id in self.docs:
            self._remove_postings(doc_id)
        self.docs[doc_id] = dict(doc)
        tokens: list[str] = []
        for v in doc.values():
            if isinstance(v, (str, int, float, bool)):
                tokens.extend(analyze(v))
        self.doc_len[doc_id] = len(tokens)
        for tok in tokens:
            self.postings.setdefault(tok, {})
            self.postings[tok][doc_id] = self.postings[tok].get(doc_id, 0) + 1

    def _remove_postings(self, doc_id: str) -> None:
        for tf in self.postings.values():
            tf.pop(doc_id, None)
        self.doc_len.pop(doc_id, None)

    def delete(self, doc_id: str) -> bool:
        if doc_id not in self.docs:
            return False
        self._remove_postings(doc_id)
        del self.docs[doc_id]
        return True

    # -- scoring -----------------------------------------------------------
    def bm25(self, terms: list[str]) -> dict[str, float]:
        """BM25 over the analyzed corpus; returns doc_id → score."""
        k1, b = 1.2, 0.75
        n_docs = len(self.docs)
        if not n_docs:
            return {}
        avg_len = sum(self.doc_len.values()) / n_docs
        scores: dict[str, float] = {}
        for term in terms:
            tf_map = self.postings.get(term)
            if not tf_map:
                continue
            df = len(tf_map)
            idf = math.log(1 + (n_docs - df + 0.5) / (df + 0.5))
            for doc_id, tf in tf_map.items():
                dl = self.doc_len.get(doc_id, 0) or 1
                denom = tf + k1 * (1 - b + b * dl / avg_len)
                scores[doc_id] = scores.get(doc_id, 0.0) + idf * tf * (k1 + 1) / denom
        return scores

    # -- matching ----------------------------------------------------------
    def match_ids(self, query: dict) -> tuple[set[str], dict[str, float]]:
        """Evaluate a query clause → (matching ids, scores)."""
        if not query or "match_all" in query:
            return set(self.docs), {i: 1.0 for i in self.docs}
        if "match" in query:
            clause = query["match"]
            # {"field": "text"} or {"field": {"query": "text"}}
            ((field, spec),) = clause.items()
            text = spec["query"] if isinstance(spec, dict) else spec
            terms = analyze(text)
            scores = self.bm25(terms)
            if field != "_all":
                scores = {
                    i: s for i, s in scores.items()
                    if any(t in analyze(self.docs[i].get(field, "")) for t in terms)
                }
            return set(scores), scores
        if "term" in query:
            ((field, value),) = query["term"].items()
            if isinstance(value, dict):
                value = value.get("value")
            ids = {i for i, d in self.docs.items() if d.get(field) == value}
            return ids, {i: 1.0 for i in ids}
        if "range" in query:
            ((field, bounds),) = query["range"].items()
            ids = set()
            for i, d in self.docs.items():
                v = d.get(field)
                if v is None:
                    continue
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    continue
                ok = True
                if "gt" in bounds and not v > bounds["gt"]:
                    ok = False
                if "gte" in bounds and not v >= bounds["gte"]:
                    ok = False
                if "lt" in bounds and not v < bounds["lt"]:
                    ok = False
                if "lte" in bounds and not v <= bounds["lte"]:
                    ok = False
                if ok:
                    ids.add(i)
            return ids, {i: 1.0 for i in ids}
        if "bool" in query:
            clause = query["bool"]
            ids = set(self.docs)
            scores: dict[str, float] = {i: 0.0 for i in self.docs}
            for sub in clause.get("must", []):
                sub_ids, sub_scores = self.match_ids(sub)
                ids &= sub_ids
                for i, s in sub_scores.items():
                    scores[i] = scores.get(i, 0.0) + s
            should = clause.get("should", [])
            if should:
                should_ids: set[str] = set()
                for sub in should:
                    sub_ids, sub_scores = self.match_ids(sub)
                    should_ids |= sub_ids
                    for i, s in sub_scores.items():
                        scores[i] = scores.get(i, 0.0) + s
                if not clause.get("must"):
                    ids &= should_ids
            for sub in clause.get("must_not", []):
                sub_ids, _ = self.match_ids(sub)
                ids -= sub_ids
            return ids, {i: scores.get(i, 0.0) or 1.0 for i in ids}
        raise SearchError(f"unsupported query clause: {sorted(query)}")


class EmbeddedSearch:
    """The SearchStore provider (Elasticsearch driver analogue)."""

    def __init__(self) -> None:
        self._indices: dict[str, _Index] = {}
        self._lock = threading.Lock()
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "EmbeddedSearch":
        return cls()

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        if self._logger:
            self._logger.debug("embedded search store ready")

    # -- index admin (datasources.go:710-717) ------------------------------
    def create_index(self, index: str, settings: dict | None = None) -> None:
        with self._lock:
            if index in self._indices:
                raise SearchError(f"index {index} already exists")
            self._indices[index] = _Index(index, settings)

    def delete_index(self, index: str) -> None:
        with self._lock:
            if self._indices.pop(index, None) is None:
                raise IndexNotFound(index)

    def indices(self) -> list[str]:
        with self._lock:
            return sorted(self._indices)

    def _index(self, name: str) -> _Index:
        idx = self._indices.get(name)
        if idx is None:
            raise IndexNotFound(name)
        return idx

    # -- documents (datasources.go:719-737) --------------------------------
    def index_document(self, index: str, id: str, document: dict) -> None:
        with self._lock:
            self._indices.setdefault(index, _Index(index)).put(str(id), document)

    def get_document(self, index: str, id: str) -> dict | None:
        with self._lock:
            doc = self._index(index).docs.get(str(id))
            return dict(doc) if doc is not None else None

    def update_document(self, index: str, id: str, update: dict) -> None:
        with self._lock:
            idx = self._index(index)
            doc = idx.docs.get(str(id))
            if doc is None:
                raise SearchError(f"document {id} not found in {index}")
            merged = dict(doc)
            merged.update(update)
            idx.put(str(id), merged)

    def delete_document(self, index: str, id: str) -> None:
        with self._lock:
            if not self._index(index).delete(str(id)):
                raise SearchError(f"document {id} not found in {index}")

    def bulk(self, operations: list[dict]) -> dict:
        """[{"index": {...,"_id","doc"}} | {"delete": {...,"_id"}}] →
        {"errors": bool, "items": [...]} (the _bulk shape)."""
        items, errors = [], False
        for op in operations:
            try:
                if "index" in op:
                    spec = op["index"]
                    self.index_document(spec["_index"], spec["_id"], spec["doc"])
                    items.append({"index": {"_id": spec["_id"], "status": 201}})
                elif "delete" in op:
                    spec = op["delete"]
                    self.delete_document(spec["_index"], spec["_id"])
                    items.append({"delete": {"_id": spec["_id"], "status": 200}})
                else:
                    raise SearchError(f"unsupported bulk op {sorted(op)}")
            except SearchError as exc:
                errors = True
                items.append({"error": str(exc), "status": exc.status_code})
        return {"errors": errors, "items": items}

    # -- search (datasources.go:739-745) -----------------------------------
    def search(self, index: str, query: dict, size: int = 10) -> dict:
        """ES-shaped response: hits.total.value + ranked hits with _score."""
        with self._lock:
            idx = self._index(index)
            q = query.get("query", query)
            ids, scores = idx.match_ids(q)
            ranked = sorted(ids, key=lambda i: (-scores.get(i, 0.0), i))[:size]
            hits = [
                {"_id": i, "_score": round(scores.get(i, 0.0), 6),
                 "_source": dict(idx.docs[i])}
                for i in ranked
            ]
        return {"hits": {"total": {"value": len(ids)}, "hits": hits}}

    # -- lifecycle / health ------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        with self._lock:
            return {
                "status": "UP",
                "details": {
                    "backend": "embedded-search",
                    "indices": len(self._indices),
                    "documents": sum(len(i.docs) for i in self._indices.values()),
                },
            }

    def close(self) -> None:
        with self._lock:
            self._indices.clear()
