"""In-process Mongo server: OP_MSG wire protocol over TCP, storage via
the embedded document store.

Pairs with datasource/document/mongo.py the way MiniMySQLServer pairs
with the MySQL dialect: the driver's tests exercise real frames end to
end, no external mongod. Commands covered: hello/isMaster, ping,
buildInfo, insert, find (+limit), update, delete, count, drop, create,
startTransaction-bearing ops, commitTransaction, abortTransaction,
endSessions.

BSON-only values (ObjectId, datetime, bytes) bridge to the JSON-backed
embedded store through MongoDB Extended-JSON shapes ($oid/$date/$binary),
so ids round-trip: insert an ObjectId, find it back as an ObjectId.

The port's copy of ``gofr_tpu/testutil/mongo_server.py``; it imports nothing of the JAX package.
Three differences, none of them a byte on the wire: each accepted socket sets
``TCP_NODELAY``, as the port's other fakes do (ROADMAP Queue C 43 and 50);
``commands`` counts every command served, by name; and ``close()`` drops
every live connection, as a mongod that went down (the reference's keeps
answering ``ping`` on them over its closed store, so a client's health stays
UP; ROADMAP Queue C 56).
"""

from __future__ import annotations

import base64
import datetime as _dt
import socket
import struct
import threading
from typing import Any

from gofr_tpu_torch.datasource.document.bson import (
    ObjectId,
    decode_document,
    encode_document,
)
from gofr_tpu_torch.datasource.document.embedded import EmbeddedDocumentStore
from gofr_tpu_torch.testutil.ports import get_free_port

OP_MSG = 2013


def to_jsonable(value: Any) -> Any:
    if isinstance(value, ObjectId):
        return {"$oid": str(value)}
    if isinstance(value, _dt.datetime):
        return {"$date": int(value.timestamp() * 1000)}
    if isinstance(value, (bytes, bytearray)):
        return {"$binary": base64.b64encode(bytes(value)).decode()}
    if isinstance(value, dict):
        return {k: to_jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [to_jsonable(v) for v in value]
    return value


def from_jsonable(value: Any) -> Any:
    if isinstance(value, dict):
        if set(value) == {"$oid"}:
            return ObjectId(value["$oid"])
        if set(value) == {"$date"}:
            return _dt.datetime.fromtimestamp(
                value["$date"] / 1000, _dt.timezone.utc
            )
        if set(value) == {"$binary"}:
            return base64.b64decode(value["$binary"])
        return {k: from_jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [from_jsonable(v) for v in value]
    return value


class _Conn:
    def __init__(self, server: "MiniMongoServer", sock: socket.socket) -> None:
        self.server = server
        self.sock = sock
        self.rbuf = b""
        # lsid bytes → open embedded-store session (transaction scope)
        self.sessions: dict[bytes, Any] = {}
        # cursor id → undelivered docs (find batches cap at 101 like a
        # real server, so drivers must implement getMore to pass)
        self.cursors: dict[int, list] = {}
        self._next_cursor = 1

    def _recv_exact(self, n: int) -> bytes | None:
        while len(self.rbuf) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            self.rbuf += chunk
        out, self.rbuf = self.rbuf[:n], self.rbuf[n:]
        return out

    def serve(self) -> None:
        try:
            while True:
                head = self._recv_exact(16)
                if head is None:
                    return
                length, req_id, _, opcode = struct.unpack("<iiii", head)
                body = self._recv_exact(length - 16)
                if body is None or opcode != OP_MSG:
                    return
                cmd, _ = decode_document(body, 5)  # flagBits + kind byte
                try:
                    reply = self.handle(cmd)
                except Exception as exc:  # noqa: BLE001 - surfaces as errmsg
                    reply = {"ok": 0.0, "errmsg": str(exc), "code": 8}
                payload = (
                    struct.pack("<I", 0) + b"\x00" + encode_document(reply)
                )
                header = struct.pack(
                    "<iiii", 16 + len(payload),
                    self.server._next_id(), req_id, OP_MSG,
                )
                self.sock.sendall(header + payload)
        finally:
            for sess in self.sessions.values():
                try:
                    sess.abort_transaction()
                except Exception:
                    pass
            with self.server._id_lock:
                self.server._conns.discard(self.sock)
            self.sock.close()

    # -- command dispatch ------------------------------------------------------
    def _target(self, cmd: dict) -> Any:
        """The store or, inside a wire transaction, its session."""
        lsid = cmd.get("lsid")
        if not isinstance(lsid, dict) or "id" not in lsid:
            return self.server.store
        key = bytes(lsid["id"])
        if cmd.get("startTransaction"):
            sess = self.server.store.start_session().start_transaction()
            self.sessions[key] = sess
            return sess
        return self.sessions.get(key, self.server.store)

    def _end_txn(self, cmd: dict, commit: bool) -> dict:
        lsid = cmd.get("lsid") or {}
        key = bytes(lsid.get("id", b""))
        sess = self.sessions.pop(key, None)
        if sess is None:
            raise RuntimeError("no transaction in progress for this session")
        if commit:
            sess.commit_transaction()
        else:
            sess.abort_transaction()
        return {"ok": 1.0}

    def handle(self, cmd: dict) -> dict:
        name = next(iter(cmd))
        with self.server._id_lock:
            self.server.commands[name] = self.server.commands.get(name, 0) + 1
        db = cmd.get("$db", "test")
        if name in ("hello", "isMaster", "ismaster"):
            return {
                "ok": 1.0, "isWritablePrimary": True,
                "maxWireVersion": 17, "minWireVersion": 0,
            }
        if name == "ping":
            return {"ok": 1.0}
        if name == "buildInfo":
            return {"ok": 1.0, "version": "7.0.0-mini"}
        if name == "endSessions":
            return {"ok": 1.0}
        if name == "commitTransaction":
            return self._end_txn(cmd, commit=True)
        if name == "abortTransaction":
            return self._end_txn(cmd, commit=False)

        store = self._target(cmd)
        coll = cmd[name]
        if name == "insert":
            docs = [to_jsonable(d) for d in cmd["documents"]]
            for d in docs:
                store.insert_one(coll, d)
            return {"ok": 1.0, "n": len(docs)}
        if name == "find":
            hits = store.find(coll, to_jsonable(cmd.get("filter") or {}))
            limit = int(cmd.get("limit", 0) or 0)
            if limit:
                hits = hits[:limit]
            docs = [from_jsonable(h) for h in hits]
            cursor_id = 0
            if len(docs) > 101 and not cmd.get("singleBatch"):
                cursor_id = self._next_cursor
                self._next_cursor += 1
                self.cursors[cursor_id] = docs[101:]
                docs = docs[:101]
            return {
                "ok": 1.0,
                "cursor": {
                    "id": cursor_id,
                    "ns": f"{db}.{coll}",
                    "firstBatch": docs,
                },
            }
        if name == "getMore":
            rest = self.cursors.pop(int(cmd["getMore"]), [])
            ns = f"{db}.{cmd.get('collection', '')}"
            return {
                "ok": 1.0,
                "cursor": {"id": 0, "ns": ns, "nextBatch": rest},
            }
        if name == "count":
            n = store.count_documents(coll, to_jsonable(cmd.get("query") or {}))
            return {"ok": 1.0, "n": n}
        if name == "update":
            modified = 0
            for spec in cmd["updates"]:
                q = to_jsonable(spec.get("q") or {})
                u = to_jsonable(spec.get("u") or {})
                if spec.get("multi"):
                    modified += store.update_many(coll, q, u)
                else:
                    modified += store.update_one(coll, q, u)
            return {"ok": 1.0, "n": modified, "nModified": modified}
        if name == "delete":
            n = 0
            for spec in cmd["deletes"]:
                q = to_jsonable(spec.get("q") or {})
                if int(spec.get("limit", 0)) == 1:
                    n += store.delete_one(coll, q)
                else:
                    n += store.delete_many(coll, q)
            return {"ok": 1.0, "n": n}
        if name == "drop":
            store.drop(coll)
            return {"ok": 1.0}
        if name == "create":
            # the embedded store creates tables lazily; touching it is enough
            store.count_documents(coll, {})
            return {"ok": 1.0}
        raise RuntimeError(f"unsupported command {name!r}")


class MiniMongoServer:
    def __init__(self, port: int = 0) -> None:
        self.port = port or get_free_port()
        self.store = EmbeddedDocumentStore(":memory:")
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._id_lock = threading.Lock()
        self._ids = 0
        self._closed = False
        self.commands: dict[str, int] = {}
        self._conns: set[socket.socket] = set()

    def _next_id(self) -> int:
        with self._id_lock:
            self._ids += 1
            return self._ids

    def start(self) -> "MiniMongoServer":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", self.port))
        self._listener.listen(16)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._id_lock:
                if self._closed:
                    sock.close()
                    return
                self._conns.add(sock)
            t = threading.Thread(
                target=_Conn(self, sock).serve, daemon=True
            )
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._closed = True
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        with self._id_lock:
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.store.close()
