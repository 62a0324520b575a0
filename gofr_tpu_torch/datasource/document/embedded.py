"""Embedded document store: the DocumentStore contract (Mongo shape,
reference container/datasources.go:232-300) over sqlite JSON storage.

Role: the reference treats Mongo/Arango/Elastic as external driver modules
behind one interface; this build ships the interface plus an embedded
engine so document-model apps (request/feature logging for inference
services) run with zero external services. Vendor drivers (Mongo etc.)
slot in behind the same Protocol when their SDKs are present.

Filter language (the subset the reference's Mongo examples use): equality,
``$gt/$gte/$lt/$lte/$ne/$in``, and ``$and`` implicitly via multiple keys.
Updates: ``$set``, ``$inc``, ``$unset``, or whole-document replacement.
Transactions: Mongo session shape (datasources.go:232-300) via
``start_session()`` → ``with session.start_transaction(): ...`` /
``session.with_transaction(fn)`` — atomic commit, rollback on abort.

The port's copy of ``gofr_tpu/datasource/document/embedded.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import uuid
from typing import Any


# Extended-JSON VALUE shapes (the wire bridge stores ObjectId/datetime/
# binary this way — testutil/mongo_server.py): they look like operator
# dicts but compare by equality.
_EXT_JSON_VALUES = ({"$oid"}, {"$date"}, {"$binary"})


def _matches(doc: dict, filter: dict) -> bool:
    for key, cond in filter.items():
        value = doc.get(key)
        if (isinstance(cond, dict)
                and any(k.startswith("$") for k in cond)
                and set(cond) not in _EXT_JSON_VALUES):
            for op, operand in cond.items():
                if op == "$gt":
                    if not (value is not None and value > operand):
                        return False
                elif op == "$gte":
                    if not (value is not None and value >= operand):
                        return False
                elif op == "$lt":
                    if not (value is not None and value < operand):
                        return False
                elif op == "$lte":
                    if not (value is not None and value <= operand):
                        return False
                elif op == "$ne":
                    if value == operand:
                        return False
                elif op == "$in":
                    if value not in operand:
                        return False
                else:
                    raise ValueError(f"unsupported filter operator {op}")
        elif value != cond:
            return False
    return True


def _apply_update(doc: dict, update: dict) -> dict:
    if not any(k.startswith("$") for k in update):
        return {**update, "_id": doc["_id"]}  # replacement keeps the id
    out = dict(doc)
    for op, fields in update.items():
        if op == "$set":
            out.update(fields)
        elif op == "$inc":
            for k, delta in fields.items():
                out[k] = out.get(k, 0) + delta
        elif op == "$unset":
            for k in fields:
                out.pop(k, None)
        else:
            raise ValueError(f"unsupported update operator {op}")
    return out


class EmbeddedDocumentStore:
    """sqlite-backed DocumentStore (one table per collection, JSON docs)."""

    def __init__(self, path: str = ":memory:") -> None:
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        # re-entrant: a session transaction holds the lock across its ops
        self._lock = threading.RLock()
        self._in_txn = False
        self._txn_owner: Any = None  # the Session holding the open transaction
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "EmbeddedDocumentStore":
        return cls(config.get_or_default("DOCUMENT_DB_PATH", ":memory:"))

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics
        try:
            metrics.new_histogram(
                "app_document_stats", "Document store operation latency"
            )
        except Exception:
            pass  # already registered

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        if self._logger:
            self._logger.info(f"document store connected ({self.path})")

    # -- internals -------------------------------------------------------------
    def _commit(self) -> None:
        """Per-op commit — suppressed while a session transaction is open
        so its ops land atomically at Session commit (or vanish on abort)."""
        if not self._in_txn:
            self._conn.commit()

    def _table(self, collection: str) -> str:
        if not collection.replace("_", "").isalnum():
            raise ValueError(f"invalid collection name {collection!r}")
        with self._lock:
            self._conn.execute(
                f'CREATE TABLE IF NOT EXISTS "doc_{collection}" '
                "(id TEXT PRIMARY KEY, body TEXT NOT NULL)"
            )
        return f"doc_{collection}"

    def _observe(self, op: str, collection: str) -> None:
        if self._metrics:
            self._metrics.record_histogram(
                "app_document_stats", 0.0, operation=op, collection=collection
            )

    def _all(self, collection: str) -> list[dict]:
        table = self._table(collection)
        with self._lock:
            rows = self._conn.execute(f'SELECT body FROM "{table}"').fetchall()
        return [json.loads(r[0]) for r in rows]

    # -- DocumentStore contract ------------------------------------------------
    def insert_one(self, collection: str, document: dict) -> Any:
        table = self._table(collection)
        doc = dict(document)
        doc.setdefault("_id", uuid.uuid4().hex)
        with self._lock:
            self._conn.execute(
                f'INSERT INTO "{table}" (id, body) VALUES (?, ?)',
                (str(doc["_id"]), json.dumps(doc)),
            )
            self._commit()
        self._observe("insert_one", collection)
        return doc["_id"]

    def insert_many(self, collection: str, documents: list[dict]) -> Any:
        return [self.insert_one(collection, d) for d in documents]

    def find(self, collection: str, filter: dict) -> list[dict]:
        self._observe("find", collection)
        return [d for d in self._all(collection) if _matches(d, filter)]

    def find_one(self, collection: str, filter: dict) -> dict | None:
        hits = self.find(collection, filter)
        return hits[0] if hits else None

    def count_documents(self, collection: str, filter: dict) -> int:
        return len(self.find(collection, filter))

    def _update_matching(self, collection: str, filter: dict, update: dict,
                         limit: int | None) -> int:
        table = self._table(collection)
        n = 0
        with self._lock:
            rows = self._conn.execute(f'SELECT id, body FROM "{table}"').fetchall()
            for row_id, body in rows:
                doc = json.loads(body)
                if not _matches(doc, filter):
                    continue
                new_doc = _apply_update(doc, update)
                self._conn.execute(
                    f'UPDATE "{table}" SET body = ? WHERE id = ?',
                    (json.dumps(new_doc), row_id),
                )
                n += 1
                if limit is not None and n >= limit:
                    break
            self._commit()
        return n

    def update_one(self, collection: str, filter: dict, update: dict) -> int:
        self._observe("update_one", collection)
        return self._update_matching(collection, filter, update, limit=1)

    def update_many(self, collection: str, filter: dict, update: dict) -> int:
        self._observe("update_many", collection)
        return self._update_matching(collection, filter, update, limit=None)

    def update_by_id(self, collection: str, id: Any, update: dict) -> int:
        return self.update_one(collection, {"_id": id}, update)

    def _delete_matching(self, collection: str, filter: dict, limit: int | None) -> int:
        table = self._table(collection)
        n = 0
        with self._lock:
            rows = self._conn.execute(f'SELECT id, body FROM "{table}"').fetchall()
            for row_id, body in rows:
                if not _matches(json.loads(body), filter):
                    continue
                self._conn.execute(f'DELETE FROM "{table}" WHERE id = ?', (row_id,))
                n += 1
                if limit is not None and n >= limit:
                    break
            self._commit()
        return n

    def delete_one(self, collection: str, filter: dict) -> int:
        self._observe("delete_one", collection)
        return self._delete_matching(collection, filter, limit=1)

    def delete_many(self, collection: str, filter: dict) -> int:
        self._observe("delete_many", collection)
        return self._delete_matching(collection, filter, limit=None)

    def drop(self, collection: str) -> None:
        table = self._table(collection)
        with self._lock:
            self._conn.execute(f'DROP TABLE IF EXISTS "{table}"')
            self._commit()

    # -- transactions (Mongo session shape, datasources.go:232-300) ------------
    def start_session(self) -> "Session":
        """Mongo-style ``StartSession``: the session's transaction scope
        makes every store operation inside it atomic (single-writer —
        the transaction holds the store's write lock, which is exactly
        sqlite's own concurrency model). Single-threaded use only."""
        return Session(self)

    # -- health ----------------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                tables = self._conn.execute(
                    "SELECT name FROM sqlite_master WHERE name LIKE 'doc_%'"
                ).fetchall()
            return {
                "status": "UP",
                "details": {
                    "backend": "embedded-document",
                    "path": self.path,
                    "collections": sorted(t[0][4:] for t in tables),
                },
            }
        except sqlite3.Error as exc:
            return {"status": "DOWN", "details": {"error": str(exc)}}

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class TransactionAborted(Exception):
    """Raise this inside a ``with session.start_transaction():`` block (or
    ``with_transaction`` callback) to roll back silently — the context
    manager absorbs it after aborting."""


class Session:
    """Mongo sessionContext analogue: StartTransaction / Commit / Abort,
    plus the ``with_transaction(fn)`` convenience that commits on return
    and aborts on exception (datasources.go:252-276)."""

    def __init__(self, store: EmbeddedDocumentStore) -> None:
        self._store = store
        self._active = False

    # -- explicit control ------------------------------------------------------
    def start_transaction(self) -> "Session":
        if self._active:
            raise RuntimeError("transaction already active on this session")
        store = self._store
        # gofrlint: disable=cancel-unreachable -- in-process re-entrant lock of an in-memory store: held for one operation, or for a session's transaction until its commit or abort, never across a wire wait
        store._lock.acquire()
        if store._txn_owner is not None:
            # the RLock is re-entrant, so a SECOND session on the same
            # thread would silently join (and later commit) the first
            # session's transaction — reject instead of breaking the outer
            # transaction's atomicity
            store._lock.release()
            raise RuntimeError(
                "another session's transaction is already open on this store"
            )
        store._txn_owner = self
        store._in_txn = True
        self._active = True
        return self

    def commit_transaction(self) -> None:
        self._end(commit=True)

    def abort_transaction(self) -> None:
        self._end(commit=False)

    def _end(self, commit: bool) -> None:
        if not self._active:
            raise RuntimeError("no active transaction")
        store = self._store
        try:
            if commit:
                store._conn.commit()
            else:
                store._conn.rollback()
        finally:
            store._in_txn = False
            store._txn_owner = None
            self._active = False
            store._lock.release()

    # -- context / callback forms ---------------------------------------------
    def __enter__(self) -> "Session":
        # `with session.start_transaction():` — already begun; `with
        # session:` alone also works
        if not self._active:
            self.start_transaction()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if not self._active:
            # the body already ended the transaction explicitly
            # (commit_transaction()/abort_transaction() mid-block) — both
            # are legitimate Mongo-session moves, nothing left to do
            return exc_type is TransactionAborted
        if exc_type is None:
            self.commit_transaction()
            return False
        self.abort_transaction()
        return exc_type is TransactionAborted  # deliberate aborts don't raise

    def with_transaction(self, fn: Any) -> Any:
        """Run ``fn(session)`` in a transaction: commit on return, abort
        on exception (re-raised), like Mongo's WithTransaction."""
        with self:
            return fn(self)

    def end_session(self) -> None:
        if self._active:
            self.abort_transaction()

    # -- store ops inside the session ------------------------------------------
    def __getattr__(self, name: str) -> Any:
        # every DocumentStore operation is valid on the session; the
        # store's re-entrant lock makes them join the open transaction
        return getattr(self._store, name)


def new_document_store(config: Any):
    """Backend selection (reference: Mongo is an external driver picked by
    config — container/datasources.go:232-300): MONGO_URI or MONGO_HOST
    selects the wire driver (document/mongo.py, real OP_MSG protocol);
    otherwise the embedded zero-service engine."""
    if config.get("MONGO_URI") or config.get("MONGO_HOST"):
        from gofr_tpu_torch.datasource.document.mongo import MongoClient

        return MongoClient.from_config(config)
    return EmbeddedDocumentStore.from_config(config)
