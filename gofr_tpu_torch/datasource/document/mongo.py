"""Mongo wire-protocol driver: OP_MSG over TCP, from-scratch BSON.

Reference parity: the Mongo interface at
pkg/gofr/container/datasources.go:232-300 (Find, FindOne,
InsertOne/Many, DeleteOne/Many, UpdateByID/One/Many, CountDocuments,
Drop, CreateCollection, StartSession + transaction shape) over the
official driver; here the same surface speaks the public wire protocol
directly (OP_MSG, opcode 2013 — the only opcode modern servers accept),
so the framework needs no vendor SDK. The embedded document store
(document/embedded.py) keeps the identical API for zero-service runs;
``new_document_store`` picks wire vs embedded by config.

Sessions/transactions ride the wire the way the real driver does: an
``lsid`` UUID per session, ``txnNumber`` + ``startTransaction`` on the
first command, ``commitTransaction``/``abortTransaction`` against the
admin database.

The port's copy of ``gofr_tpu/datasource/document/mongo.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import time
from typing import Any

from gofr_tpu_torch.datasource.document.bson import (
    Binary,
    Int64,
    ObjectId,
    decode_document,
    encode_document,
)

OP_MSG = 2013


class MongoError(RuntimeError):
    pass


def _parse_uri(uri: str) -> dict:
    # mongodb://host[:port][/database]
    out: dict = {}
    if uri.startswith("mongodb://"):
        rest = uri[len("mongodb://") :]
        if "@" in rest:  # credentials not used by the test rig; keep host part
            rest = rest.rsplit("@", 1)[1]
        hostport, _, db = rest.partition("/")
        host, _, port = hostport.partition(":")
        out["host"] = host
        if port:
            out["port"] = int(port)
        if db:
            out["database"] = db.split("?")[0]
    return out


class MongoSession:
    """Wire twin of the embedded store's Session (Transaction shape at
    datasources.go:287-292): start_transaction() as a context manager,
    commit/abort, with_transaction convenience."""

    def __init__(self, client: "MongoClient") -> None:
        self._client = client
        # subtype 4 (UUID): real servers reject subtype-0 session ids
        self.lsid = {"id": Binary(os.urandom(16), subtype=4)}
        self._txn = itertools.count(1)
        self.txn_number: int | None = None
        self._first_op = False

    # -- transaction control ---------------------------------------------------
    def start_transaction(self) -> "MongoSession":
        if self.txn_number is not None:
            raise MongoError("transaction already in progress")
        self.txn_number = next(self._txn)
        self._first_op = True
        return self

    def commit_transaction(self) -> None:
        self._finish("commitTransaction")

    def abort_transaction(self) -> None:
        self._finish("abortTransaction")

    def _finish(self, cmd: str) -> None:
        if self.txn_number is None:
            raise MongoError("no transaction in progress")
        try:
            if not self._first_op:  # nothing ran → nothing to commit server-side
                self._client._command(
                    {cmd: 1, "lsid": self.lsid,
                     "txnNumber": Int64(self.txn_number),
                     "autocommit": False},
                    db="admin",
                )
        finally:
            self.txn_number = None

    def __enter__(self) -> "MongoSession":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if self.txn_number is not None:
            if exc_type is None:
                self.commit_transaction()
            else:
                self.abort_transaction()
        return False

    def with_transaction(self, fn: Any) -> Any:
        with self.start_transaction():
            return fn(self)

    def end_session(self) -> None:
        self._client._command(
            {"endSessions": [self.lsid]}, db="admin", quiet=True
        )

    def _txn_fields(self) -> dict:
        fields: dict = {"lsid": self.lsid}
        if self.txn_number is not None:
            fields["txnNumber"] = Int64(self.txn_number)  # long, never int32
            fields["autocommit"] = False
            if self._first_op:
                fields["startTransaction"] = True
                self._first_op = False
        return fields

    def __getattr__(self, name: str) -> Any:
        """Store operations are valid on the session and join the open
        transaction (mirrors embedded Session.__getattr__)."""
        op = getattr(self._client, name)
        if not callable(op):
            return op

        def bound(*args: Any, **kw: Any) -> Any:
            return op(*args, session=self, **kw)

        return bound


class MongoClient:
    """The Mongo contract over the real wire. API mirrors
    EmbeddedDocumentStore so either backs the same app code."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 27017,
        database: str = "test",
        uri: str = "",
        connect_timeout: float = 5.0,
    ) -> None:
        parsed = _parse_uri(uri) if uri else {}
        self.host = parsed.get("host", host)
        self.port = int(parsed.get("port", port))
        self.database = parsed.get("database", database)
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None
        self._rbuf = b""
        self._req_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "MongoClient":
        return cls(
            host=config.get_or_default("MONGO_HOST", "localhost"),
            port=int(config.get_or_default("MONGO_PORT", "27017")),
            database=config.get_or_default("MONGO_DATABASE", "test"),
            uri=config.get_or_default("MONGO_URI", ""),
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics
        try:
            metrics.new_histogram("app_mongo_stats", "Mongo operation latency")
        except Exception:
            pass

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        hello = self._command({"hello": 1}, db="admin")
        if self._logger:
            self._logger.info(
                f"connected to Mongo at {self.host}:{self.port} "
                f"(maxWireVersion={hello.get('maxWireVersion')})"
            )

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # -- wire ------------------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        assert self._sock is not None
        while len(self._rbuf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise MongoError("connection closed by server")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _command(
        self, doc: dict, db: str | None = None, quiet: bool = False
    ) -> dict:
        if self._sock is None:
            raise MongoError("not connected (call connect())")
        body = dict(doc)
        body["$db"] = db or self.database
        payload = struct.pack("<I", 0) + b"\x00" + encode_document(body)
        req_id = next(self._req_ids)
        header = struct.pack(
            "<iiii", 16 + len(payload), req_id, 0, OP_MSG
        )
        with self._lock:
            # gofrlint: disable=hold-and-block -- request/response pairing on
            # the shared wire: the lock MUST span send+recv or replies cross
            self._sock.sendall(header + payload)
            (length,) = struct.unpack("<i", self._recv_exact(4))
            rest = self._recv_exact(length - 4)
        _, _, opcode = struct.unpack_from("<iii", rest, 0)
        if opcode != OP_MSG:
            raise MongoError(f"unexpected reply opcode {opcode}")
        # skip flagBits (4) + section kind byte (1)
        reply, _ = decode_document(rest, 17)
        if not quiet and reply.get("ok") != 1 and reply.get("ok") != 1.0:
            raise MongoError(
                reply.get("errmsg", f"command failed: {reply}")
            )
        return reply

    def _observe(self, op: str, collection: str, start: float) -> None:
        if self._metrics:
            self._metrics.record_histogram(
                "app_mongo_stats", time.perf_counter() - start,
                operation=op, collection=collection,
            )
        if self._logger:
            self._logger.debug(f"mongo {op} {collection}")

    def _run(self, op: str, collection: str, doc: dict,
             session: "MongoSession | None") -> dict:
        start = time.perf_counter()
        if session is not None:
            doc.update(session._txn_fields())
        span = (
            self._tracer.start_span(f"mongo.{op}", kind="client")
            if self._tracer else None
        )
        try:
            return self._command(doc)
        finally:
            if span is not None:
                span.__exit__(None, None, None)
            self._observe(op, collection, start)

    # -- DocumentStore contract (datasources.go:232-300) -----------------------
    def insert_one(self, collection: str, document: dict, *,
                   session: MongoSession | None = None) -> Any:
        doc = dict(document)
        doc.setdefault("_id", ObjectId())
        self._run("insert", collection,
                  {"insert": collection, "documents": [doc]}, session)
        return doc["_id"]

    def insert_many(self, collection: str, documents: list[dict], *,
                    session: MongoSession | None = None) -> list[Any]:
        docs = [dict(d) for d in documents]
        for d in docs:
            d.setdefault("_id", ObjectId())
        self._run("insert", collection,
                  {"insert": collection, "documents": docs}, session)
        return [d["_id"] for d in docs]

    def find(self, collection: str, filter: dict | None = None, *,
             session: MongoSession | None = None) -> list[dict]:
        reply = self._run("find", collection,
                          {"find": collection, "filter": filter or {}}, session)
        cursor = reply["cursor"]
        docs = list(cursor["firstBatch"])
        cid = int(cursor.get("id", 0))
        while cid:  # real servers cap firstBatch (101 docs); drain getMore
            more = self._run(
                "getMore", collection,
                {"getMore": Int64(cid), "collection": collection}, session,
            )
            cursor = more["cursor"]
            docs.extend(cursor["nextBatch"])
            cid = int(cursor.get("id", 0))
        return docs

    def find_one(self, collection: str, filter: dict | None = None, *,
                 session: MongoSession | None = None) -> dict | None:
        reply = self._run(
            "find", collection,
            {"find": collection, "filter": filter or {}, "limit": 1,
             "singleBatch": True},
            session,
        )
        batch = reply["cursor"]["firstBatch"]
        return batch[0] if batch else None

    def count_documents(self, collection: str, filter: dict | None = None, *,
                        session: MongoSession | None = None) -> int:
        reply = self._run("count", collection,
                          {"count": collection, "query": filter or {}}, session)
        return int(reply["n"])

    def update_one(self, collection: str, filter: dict, update: dict, *,
                   session: MongoSession | None = None) -> int:
        return self._update(collection, filter, update, multi=False,
                            session=session)

    def update_many(self, collection: str, filter: dict, update: dict, *,
                    session: MongoSession | None = None) -> int:
        return self._update(collection, filter, update, multi=True,
                            session=session)

    def update_by_id(self, collection: str, id: Any, update: dict, *,
                     session: MongoSession | None = None) -> int:
        return self._update(collection, {"_id": id}, update, multi=False,
                            session=session)

    def _update(self, collection: str, filter: dict, update: dict, *,
                multi: bool, session: MongoSession | None) -> int:
        reply = self._run(
            "update", collection,
            {"update": collection,
             "updates": [{"q": filter, "u": update, "multi": multi}]},
            session,
        )
        return int(reply.get("nModified", reply.get("n", 0)))

    def delete_one(self, collection: str, filter: dict, *,
                   session: MongoSession | None = None) -> int:
        return self._delete(collection, filter, limit=1, session=session)

    def delete_many(self, collection: str, filter: dict, *,
                    session: MongoSession | None = None) -> int:
        return self._delete(collection, filter, limit=0, session=session)

    def _delete(self, collection: str, filter: dict, *, limit: int,
                session: MongoSession | None) -> int:
        reply = self._run(
            "delete", collection,
            {"delete": collection,
             "deletes": [{"q": filter, "limit": limit}]},
            session,
        )
        return int(reply["n"])

    def drop(self, collection: str, *,
             session: MongoSession | None = None) -> None:
        try:
            self._run("drop", collection, {"drop": collection}, session)
        except MongoError as exc:
            if "ns not found" not in str(exc):
                raise

    def create_collection(self, name: str, *,
                          session: MongoSession | None = None) -> None:
        self._run("create", name, {"create": name}, session)

    def start_session(self) -> MongoSession:
        return MongoSession(self)

    # -- health ----------------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            self._command({"ping": 1}, db="admin")
            return {
                "status": "UP",
                "details": {
                    "backend": "mongo-wire",
                    "host": f"{self.host}:{self.port}",
                    "database": self.database,
                },
            }
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": str(exc)}}
