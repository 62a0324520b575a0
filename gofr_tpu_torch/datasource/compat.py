"""Vendor-interface facades: Oracle / SurrealDB / ArangoDB / Couchbase.

Reference parity: container/datasources.go declares per-vendor
interfaces (OracleDB :210-230, SurrealDB :302-344, ArangoDB :637-706,
Couchbase :748-788) whose capabilities this repo already provides
through the family engines (sql, document, graph, kv/search). These
facades close the remaining interface-shape gap:
a GoFr user who programmed against the vendor interface finds the same
method surface here, delegating to the corresponding family engine —
the datasource breadth is capability-complete AND shape-complete.

Each facade follows the provider pattern (use_logger/use_metrics/
use_tracer/connect, datasources.go:346-359) and reports health like any
first-class driver.

The port's copy of ``gofr_tpu/datasource/compat.py``; it imports nothing of
the JAX package. The facades delegate to whichever family engines they are
given, the port's or any object with the same methods.
"""

from __future__ import annotations

import re
import uuid
from typing import Any, Callable

from gofr_tpu_torch.datasource.sql.sqlite import bind_rows


class _FacadeBase:
    """Provider-pattern plumbing shared by the vendor facades."""

    backend_attr = "_backend"

    def __init__(self) -> None:
        self._logger: Any = None
        self._metrics: Any = None

    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        backend = getattr(self, self.backend_attr)
        if hasattr(backend, "connect"):
            backend.connect()

    def _delegated_health(self, kind: str, backend: Any) -> dict[str, Any]:
        inner = (
            backend.health_check() if hasattr(backend, "health_check")
            else {"status": "UP", "details": {}}
        )
        inner.setdefault("details", {})["facade"] = kind
        return inner


class OracleFacade(_FacadeBase):
    """OracleDB interface (datasources.go:210-230) over any in-tree SQL
    DB contract (sqlite/postgres/mysql): Exec / Select / Begin."""

    backend_attr = "sql"

    def __init__(self, sql: Any) -> None:
        super().__init__()
        self.sql = sql

    def exec(self, query: str, *args: Any) -> None:
        self.sql.exec(query, *args)

    def select(self, dest: Any, query: str, *args: Any) -> Any:
        return self.sql.select(dest, query, *args)

    def begin(self) -> "OracleTxFacade":
        return OracleTxFacade(self.sql.begin())

    def health_check(self) -> dict[str, Any]:
        return self._delegated_health("oracle", self.sql)


class OracleTxFacade:
    """OracleTx (datasources.go:218-223)."""

    def __init__(self, tx: Any) -> None:
        self._tx = tx

    def exec_context(self, query: str, *args: Any) -> None:
        self._tx.exec(query, *args)

    def select_context(self, dest: Any, query: str, *args: Any) -> Any:
        return bind_rows(self._tx.query(query, *args), dest)

    def commit(self) -> None:
        self._tx.commit()

    def rollback(self) -> None:
        self._tx.rollback()


class SurrealFacade(_FacadeBase):
    """SurrealDB interface (datasources.go:302-344) over the document
    family: namespaces/databases scope collection names; Create/Update/
    Delete/Select map to document CRUD; Query serves the
    ``SELECT * FROM <table>`` core of SurrealQL."""

    backend_attr = "document"

    def __init__(self, document: Any) -> None:
        super().__init__()
        self.document = document
        self._namespace = "default"
        self._database = "default"
        self._known: set[tuple[str, str]] = {("default", "default")}

    # -- namespace / database management -----------------------------------
    def create_namespace(self, namespace: str) -> None:
        self._known.add((namespace, "default"))

    def create_database(self, database: str) -> None:
        self._known.add((self._namespace, database))

    def drop_namespace(self, namespace: str) -> None:
        for ns, db in list(self._known):
            if ns == namespace:
                self._known.discard((ns, db))

    def drop_database(self, database: str) -> None:
        self._known.discard((self._namespace, database))

    def use(self, namespace: str, database: str) -> None:
        self._namespace, self._database = namespace, database
        self._known.add((namespace, database))

    def _collection(self, table: str) -> str:
        return f"{self._namespace}__{self._database}__{table}"

    # -- records ------------------------------------------------------------
    def create(self, table: str, data: dict) -> dict:
        doc = dict(data)
        # random ids, not count+1: a count-derived id collides with a
        # surviving record after any delete
        doc.setdefault("_id", f"{table}:{uuid.uuid4().hex[:12]}")
        self.document.insert_one(self._collection(table), doc)
        return doc

    def update(self, table: str, id: str, data: dict) -> Any:
        self.document.update_by_id(self._collection(table), id, {"$set": dict(data)})
        return self.document.find_one(self._collection(table), {"_id": id})

    def delete(self, table: str, id: str) -> Any:
        return self.document.delete_one(self._collection(table), {"_id": id})

    def select(self, table: str) -> list[dict]:
        return self.document.find(self._collection(table), {})

    def query(self, query: str, vars: dict | None = None) -> list[Any]:
        """The ``SELECT * FROM <table> [WHERE k = $var]`` core of
        SurrealQL, which covers the reference examples."""
        m = re.match(
            r"\s*SELECT\s+\*\s+FROM\s+(\w+)(?:\s+WHERE\s+(\w+)\s*=\s*\$(\w+))?\s*;?\s*$",
            query, re.IGNORECASE,
        )
        if not m:
            raise ValueError(f"unsupported SurrealQL: {query!r}")
        table, field, var = m.groups()
        flt: dict = {}
        if field is not None:
            flt[field] = (vars or {}).get(var)
        return self.document.find(self._collection(table), flt)

    def health_check(self) -> dict[str, Any]:
        return self._delegated_health("surrealdb", self.document)


class ArangoFacade(_FacadeBase):
    """ArangoDB interface (datasources.go:637-706): documents delegate to
    the document family (``db__collection`` scoping), graphs/edges to the
    graph family."""

    backend_attr = "document"

    def __init__(self, document: Any, graph: Any) -> None:
        super().__init__()
        self.document = document
        self.graph = graph
        self._databases: set[str] = set()
        self._collections: dict[tuple[str, str], bool] = {}  # (db, col) → is_edge
        self._graphs: dict[tuple[str, str], Any] = {}

    def connect(self) -> None:
        super().connect()
        if hasattr(self.graph, "connect"):
            self.graph.connect()

    # -- databases / collections / graphs -----------------------------------
    def create_db(self, database: str) -> None:
        self._databases.add(database)

    def drop_db(self, database: str) -> None:
        self._databases.discard(database)
        for db, col in list(self._collections):
            if db == database:
                del self._collections[(db, col)]

    def create_collection(self, database: str, collection: str, is_edge: bool) -> None:
        self._collections[(database, collection)] = is_edge

    def drop_collection(self, database: str, collection: str) -> None:
        self._collections.pop((database, collection), None)
        self.document.drop(f"{database}__{collection}")

    def create_graph(self, database: str, graph: str, edge_definitions: Any) -> None:
        if edge_definitions is None:
            raise ValueError("edgeDefinitions must not be nil (datasources.go:656)")
        self._graphs[(database, graph)] = edge_definitions

    def drop_graph(self, database: str, graph: str) -> None:
        self._graphs.pop((database, graph), None)

    # -- documents -----------------------------------------------------------
    def _col(self, database: str, collection: str) -> str:
        return f"{database}__{collection}"

    def create_document(self, db_name: str, collection: str, document: dict) -> str:
        doc = dict(document)
        doc_id = doc.setdefault("_id", f"{collection}/{uuid.uuid4().hex[:12]}")
        self.document.insert_one(self._col(db_name, collection), doc)
        if self._collections.get((db_name, collection)):
            # an edge collection document IS an edge: _from → _to
            self.graph.mutate(set=[{
                "uid": f"_:{doc_id}", "edge_src": doc.get("_from", ""),
                "edge_dst": doc.get("_to", ""),
            }])
        return str(doc_id)

    def get_document(self, db_name: str, collection: str, document_id: str) -> dict | None:
        return self.document.find_one(
            self._col(db_name, collection), {"_id": document_id}
        )

    def update_document(self, db_name: str, collection: str, document_id: str,
                        document: dict) -> None:
        self.document.update_by_id(
            self._col(db_name, collection), document_id, {"$set": dict(document)}
        )

    def delete_document(self, db_name: str, collection: str, document_id: str) -> None:
        self.document.delete_one(self._col(db_name, collection), {"_id": document_id})

    def get_edges(self, db_name: str, graph_name: str, edge_collection: str,
                  vertex_id: str) -> list[dict]:
        """All edges touching ``vertex_id`` in the edge collection."""
        col = self._col(db_name, edge_collection)
        out = self.document.find(col, {"_from": vertex_id})
        inbound = self.document.find(col, {"_to": vertex_id})
        return out + inbound

    def health_check(self) -> dict[str, Any]:
        return self._delegated_health("arangodb", self.document)


class CouchbaseFacade(_FacadeBase):
    """Couchbase interface (datasources.go:748-788): keyed documents over
    the document family (bucket = one collection), N1QL's core SELECT
    over the same engine, transactions via the document session."""

    backend_attr = "document"

    def __init__(self, document: Any, bucket: str = "default") -> None:
        super().__init__()
        self.document = document
        self.bucket = bucket

    def get(self, key: str) -> dict | None:
        doc = self.document.find_one(self.bucket, {"_id": key})
        if doc is None:
            return None
        doc = dict(doc)
        doc.pop("_id", None)
        return doc

    def insert(self, key: str, document: dict) -> dict:
        if self.document.find_one(self.bucket, {"_id": key}) is not None:
            raise KeyError(f"document exists: {key}")
        self.document.insert_one(self.bucket, {"_id": key, **document})
        return dict(document)

    def upsert(self, key: str, document: dict) -> dict:
        # Couchbase upsert REPLACES the whole document — a $set merge
        # would leave stale fields behind
        self.document.delete_one(self.bucket, {"_id": key})
        self.document.insert_one(self.bucket, {"_id": key, **document})
        return dict(document)

    def remove(self, key: str) -> None:
        self.document.delete_one(self.bucket, {"_id": key})

    def query(self, statement: str, params: dict | None = None) -> list[dict]:
        """The ``SELECT * FROM <bucket> [WHERE k = $var]`` core of N1QL."""
        m = re.match(
            r"\s*SELECT\s+\*\s+FROM\s+`?(\w+)`?(?:\s+WHERE\s+(\w+)\s*=\s*\$(\w+))?\s*;?\s*$",
            statement, re.IGNORECASE,
        )
        if not m:
            raise ValueError(f"unsupported N1QL: {statement!r}")
        bucket, field, var = m.groups()
        flt: dict = {}
        if field is not None:
            flt[field] = (params or {}).get(var)
        return self.document.find(bucket, flt)

    def analytics_query(self, statement: str, params: dict | None = None) -> list[dict]:
        # the analytics service accepts the same core surface here
        return self.query(statement, params)

    def run_transaction(self, logic: Callable[[Any], None]) -> Any:
        """RunTransaction (datasources.go:774): commit on return, abort on
        exception, via the document family's session transactions."""
        session = self.document.start_session()
        return session.with_transaction(lambda s: logic(s))

    def health_check(self) -> dict[str, Any]:
        return self._delegated_health("couchbase", self.document)
