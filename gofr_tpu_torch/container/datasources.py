"""Datasource contracts and the provider pattern.

Reference parity: pkg/gofr/container/datasources.go (832 LoC, 55 interfaces).
Python Protocols replace Go interfaces. Every external datasource follows the
provider pattern (datasources.go:346-359): ``use_logger`` / ``use_metrics`` /
``use_tracer`` / ``connect``, plus ``HealthChecker`` (:360-364). The TPU
datasource (SURVEY §2.9, the native core of this build) gets a first-class
contract here alongside the storage interfaces.

The port's copy of ``gofr_tpu/container/datasources.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Iterable, Protocol, runtime_checkable


@runtime_checkable
class HealthChecker(Protocol):
    """datasources.go:360-364."""

    def health_check(self) -> dict[str, Any]: ...


@runtime_checkable
class Provider(Protocol):
    """The lifecycle contract every pluggable datasource implements
    (datasources.go:346-359)."""

    def use_logger(self, logger: Any) -> None: ...

    def use_metrics(self, metrics: Any) -> None: ...

    def use_tracer(self, tracer: Any) -> None: ...

    def connect(self) -> None: ...


@runtime_checkable
class DB(Protocol):
    """SQL contract (datasources.go:18-31)."""

    def query(self, sql: str, *args: Any) -> list[dict[str, Any]]: ...

    def query_row(self, sql: str, *args: Any) -> dict[str, Any] | None: ...

    def exec(self, sql: str, *args: Any) -> Any: ...

    def select(self, target: Any, sql: str, *args: Any) -> Any: ...

    def begin(self) -> "Tx": ...

    def close(self) -> None: ...


@runtime_checkable
class Tx(Protocol):
    def query(self, sql: str, *args: Any) -> list[dict[str, Any]]: ...

    def exec(self, sql: str, *args: Any) -> Any: ...

    def commit(self) -> None: ...

    def rollback(self) -> None: ...


@runtime_checkable
class Redis(Protocol):
    """Redis contract (datasources.go:33-38; command surface mirrors
    redis.Cmdable's common subset)."""

    def get(self, key: str) -> str | None: ...

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> bool: ...

    def delete(self, *keys: str) -> int: ...

    def exists(self, *keys: str) -> int: ...

    def incr(self, key: str) -> int: ...

    def hset(self, key: str, field: str, value: Any) -> int: ...

    def hget(self, key: str, field: str) -> str | None: ...

    def hgetall(self, key: str) -> dict[str, str]: ...

    def expire(self, key: str, ttl_seconds: float) -> bool: ...

    def ttl(self, key: str) -> float: ...

    def ping(self) -> bool: ...

    def close(self) -> None: ...


@runtime_checkable
class KVStore(Protocol):
    """Key-value contract (datasources.go:366-378)."""

    def get(self, key: str) -> str: ...

    def set(self, key: str, value: str) -> None: ...

    def delete(self, key: str) -> None: ...


@runtime_checkable
class PubSub(Protocol):
    """Broker client contract (datasource/pubsub/interface.go:11-33)."""

    def publish(self, topic: str, message: bytes) -> None: ...

    def subscribe(self, topic: str) -> Any: ...  # returns Message

    def create_topic(self, name: str) -> None: ...

    def delete_topic(self, name: str) -> None: ...

    def close(self) -> None: ...


@runtime_checkable
class FileSystem(Protocol):
    """File store contract (datasource/file/interface.go:12-133)."""

    def create(self, name: str) -> Any: ...

    def open(self, name: str) -> Any: ...

    def open_file(self, name: str, mode: str) -> Any: ...

    def remove(self, name: str) -> None: ...

    def rename(self, old: str, new: str) -> None: ...

    def mkdir(self, name: str, parents: bool = True) -> None: ...

    def remove_all(self, name: str) -> None: ...

    def read_dir(self, name: str) -> list[Any]: ...

    def stat(self, name: str) -> Any: ...

    def chdir(self, name: str) -> None: ...

    def getwd(self) -> str: ...


@runtime_checkable
class TPU(Protocol):
    """The TPU datasource contract — this build's native core (SURVEY §2.9,
    BASELINE.json north star: ``ctx.TPU.execute(...)`` inside ordinary
    handlers).

    Implementations own: device/mesh discovery, the executable cache
    (compile-or-load keyed by fn+shapes+sharding), device buffers, HBM stats
    surfaced into health/metrics, and async execution with per-call tracing.
    """

    def compile(self, name: str, fn: Any, *abstract_args: Any, **options: Any) -> Any: ...

    def execute(self, name: str, *args: Any, **kwargs: Any) -> Any: ...

    def device_count(self) -> int: ...

    def mesh(self) -> Any: ...

    def hbm_stats(self) -> dict[str, Any]: ...

    def health_check(self) -> dict[str, Any]: ...


# Document-store contracts (datasources.go:232-300 Mongo, :42-194 Cassandra,
# :196-208 Clickhouse, :637-706 ArangoDB, :708-746 Elasticsearch, ...).
# The in-tree build ships generic Document/Wide-column protocols that the
# external drivers satisfy; per-vendor drivers are gated optional modules.


@runtime_checkable
class DocumentStore(Protocol):
    """Generic document DB contract (Mongo shape, datasources.go:232-300)."""

    def insert_one(self, collection: str, document: dict) -> Any: ...

    def insert_many(self, collection: str, documents: list[dict]) -> Any: ...

    def find(self, collection: str, filter: dict) -> list[dict]: ...

    def find_one(self, collection: str, filter: dict) -> dict | None: ...

    def update_by_id(self, collection: str, id: Any, update: dict) -> int: ...

    def update_one(self, collection: str, filter: dict, update: dict) -> int: ...

    def update_many(self, collection: str, filter: dict, update: dict) -> int: ...

    def count_documents(self, collection: str, filter: dict) -> int: ...

    def delete_one(self, collection: str, filter: dict) -> int: ...

    def delete_many(self, collection: str, filter: dict) -> int: ...

    def drop(self, collection: str) -> None: ...


@runtime_checkable
class WideColumnStore(Protocol):
    """Cassandra/Scylla-shaped contract (datasources.go:42-194, :600-635)."""

    def query(self, target: Any, stmt: str, *values: Any) -> Any: ...

    def exec(self, stmt: str, *values: Any) -> None: ...

    def exec_cas(self, target: Any, stmt: str, *values: Any) -> bool: ...

    def new_batch(self, name: str, batch_type: int) -> None: ...

    def batch_query(self, name: str, stmt: str, *values: Any) -> None: ...

    def execute_batch(self, name: str) -> None: ...


@runtime_checkable
class SearchStore(Protocol):
    """Elasticsearch-shaped contract (datasources.go:708-746)."""

    def create_index(self, index: str, settings: dict | None = None) -> None: ...

    def delete_index(self, index: str) -> None: ...

    def index_document(self, index: str, id: str, document: dict) -> None: ...

    def get_document(self, index: str, id: str) -> dict | None: ...

    def update_document(self, index: str, id: str, update: dict) -> None: ...

    def delete_document(self, index: str, id: str) -> None: ...

    def search(self, index: str, query: dict, size: int = 10) -> dict: ...

    def bulk(self, operations: list[dict]) -> dict: ...


@runtime_checkable
class TimeSeriesStore(Protocol):
    """InfluxDB/OpenTSDB-shaped contract (datasources.go:790-830,
    :493-598)."""

    def write_point(self, measurement: str, tags: dict | None = None,
                    fields: dict | None = None, timestamp: float | None = None) -> None: ...

    def query(self, measurement: str, field: str, **options: Any) -> list[dict]: ...

    def measurements(self) -> list[str]: ...

    def delete_series(self, measurement: str, tags: dict | None = None) -> int: ...


@runtime_checkable
class OracleDB(Protocol):
    """Oracle-shaped contract (datasources.go:210-230); served by
    datasource/compat.OracleFacade over any in-tree SQL dialect."""

    def exec(self, query: str, *args: Any) -> None: ...

    def select(self, dest: Any, query: str, *args: Any) -> Any: ...

    def begin(self) -> Any: ...


@runtime_checkable
class SurrealDB(Protocol):
    """SurrealDB-shaped contract (datasources.go:302-344); served by
    datasource/compat.SurrealFacade over the document family."""

    def create_namespace(self, namespace: str) -> None: ...

    def create_database(self, database: str) -> None: ...

    def drop_namespace(self, namespace: str) -> None: ...

    def drop_database(self, database: str) -> None: ...

    def query(self, query: str, vars: dict | None = None) -> list[Any]: ...

    def create(self, table: str, data: dict) -> dict: ...

    def update(self, table: str, id: str, data: dict) -> Any: ...

    def delete(self, table: str, id: str) -> Any: ...

    def select(self, table: str) -> list[dict]: ...


@runtime_checkable
class ArangoDB(Protocol):
    """ArangoDB-shaped contract (datasources.go:637-706); served by
    datasource/compat.ArangoFacade over the document + graph families."""

    def create_db(self, database: str) -> None: ...

    def drop_db(self, database: str) -> None: ...

    def create_collection(self, database: str, collection: str, is_edge: bool) -> None: ...

    def drop_collection(self, database: str, collection: str) -> None: ...

    def create_graph(self, database: str, graph: str, edge_definitions: Any) -> None: ...

    def drop_graph(self, database: str, graph: str) -> None: ...

    def create_document(self, db_name: str, collection: str, document: dict) -> str: ...

    def get_document(self, db_name: str, collection: str, document_id: str) -> dict | None: ...

    def update_document(self, db_name: str, collection: str, document_id: str, document: dict) -> None: ...

    def delete_document(self, db_name: str, collection: str, document_id: str) -> None: ...

    def get_edges(self, db_name: str, graph_name: str, edge_collection: str, vertex_id: str) -> list[dict]: ...


@runtime_checkable
class Couchbase(Protocol):
    """Couchbase-shaped contract (datasources.go:748-788); served by
    datasource/compat.CouchbaseFacade over the document family."""

    def get(self, key: str) -> dict | None: ...

    def insert(self, key: str, document: dict) -> dict: ...

    def upsert(self, key: str, document: dict) -> dict: ...

    def remove(self, key: str) -> None: ...

    def query(self, statement: str, params: dict | None = None) -> list[dict]: ...

    def analytics_query(self, statement: str, params: dict | None = None) -> list[dict]: ...

    def run_transaction(self, logic: Any) -> Any: ...


@runtime_checkable
class Cache(Protocol):
    """TPU-build addition: response/KV-prefix cache contract used by the
    serving layer (prefix cache reuse across requests)."""

    def get(self, key: str) -> Any | None: ...

    def put(self, key: str, value: Any) -> None: ...

    def evict(self, key: str) -> None: ...

    def stats(self) -> dict[str, Any]: ...


def wire_provider(ds: Any, logger: Any, metrics: Any, tracer: Any) -> None:
    """Apply the provider pattern to a datasource then connect it
    (container/container.go external-DB wiring; datasources.go:346-359)."""
    if hasattr(ds, "use_logger"):
        ds.use_logger(logger)
    if hasattr(ds, "use_metrics"):
        ds.use_metrics(metrics)
    if hasattr(ds, "use_tracer"):
        ds.use_tracer(tracer)
    if hasattr(ds, "connect"):
        ds.connect()


def iter_health_checkers(pairs: Iterable[tuple[str, Any]]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name, ds in pairs:
        if ds is None:
            continue
        check = getattr(ds, "health_check", None)
        if callable(check):
            try:
                out[name] = check()
            except Exception as exc:
                out[name] = {"status": "DOWN", "error": str(exc)}
    return out
