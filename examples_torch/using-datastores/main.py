"""Generation jobs whose state, records, usage and index live in the KV,
document, wide-column and search datasources, with the device's memory
sampled into the time-series store (an example of the PyTorch port; the JAX
package has no counterpart).

``POST /jobs/{id}`` with ``{"prompt": [token ids]}``:

1. claims the id in the wide-column ``jobs`` table with ``INSERT ... IF NOT
   EXISTS``; a second claim of the same id is a 409 and admits nothing;
2. sets ``job:<id>`` to ``"running"`` in ``ctx.kv_store``;
3. submits the prompt (greedy) and waits for its tokens;
4. inserts ``{_id, prompt, tokens, ttft_ms}`` into the ``jobs`` collection in
   one session transaction of the document store;
5. writes the ``usage`` row and the claim's new state in one logged batch;
6. adds ``{id, text}`` (``text`` the tokens as words ``t<id>``) to the
   ``jobs`` search index;
7. sets ``job:<id>`` to ``"done"`` and replies ``{"id", "tokens"}``.

A failure after step 3 is a 5xx that leaves the claim row and
``"running"`` behind. ``GET /search?q=t<token>`` returns the ids of the
jobs whose tokens hold it, best first. Each step runs in a span of its own
(``kv.set``, ``widecolumn.claim``, ``engine.generate``, ``document.insert``,
``widecolumn.batch``, ``search.add``, ``search.query``).

The handlers speak the contracts of the package's stores, so any backend
fits: ``EmbeddedDocumentStore`` or ``MongoClient``,
``EmbeddedWideColumnStore`` or ``CassandraClient``, ``InMemoryKVStore``,
``FileKVStore`` or ``DynamoDBKVStore``, and ``EmbeddedSearch`` or a
``SolrClient`` behind :class:`SolrIndex`.

Run it from its directory, ``cd examples_torch/using-datastores && python
main.py``: the app reads ``configs/.env`` there (a tiny model on the CPU,
the embedded stores and a ``FileKVStore`` under ``./data``; ``MONGO_HOST``,
``CASSANDRA_HOST``, ``DYNAMODB_ENDPOINT`` and ``SOLR_URL`` pick the wire
drivers), then ``curl -X POST localhost:8000/jobs/a -d '{"prompt": [5, 6,
7]}'`` and ``curl 'localhost:8000/search?q=t42'``."""

import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gofr_tpu_torch.http.errors import ErrorEntityAlreadyExist  # noqa: E402

MIGRATIONS_TABLES = (
    "CREATE TABLE IF NOT EXISTS jobs (id text PRIMARY KEY, state text)",
    "CREATE TABLE IF NOT EXISTS usage (id text PRIMARY KEY, prompt_tokens int, new_tokens int)",
)
INDEX = "jobs"


def job_text(tokens: list[int]) -> str:
    return " ".join(f"t{tok}" for tok in tokens)


class SolrIndex:
    """The search contract the handlers and the migrations use
    (``create_index``, ``indices``, ``index_document`` and ``search`` with a
    ``match_all`` or an ``_all`` ``match`` query, ES-shaped hits) over a
    ``SolrClient``: an index is a collection, a document carries its id,
    and each add commits."""

    def __init__(self, client) -> None:
        self.client = client

    def use_logger(self, logger) -> None:
        self.client.use_logger(logger)

    def use_metrics(self, metrics) -> None:
        self.client.use_metrics(metrics)

    def use_tracer(self, tracer) -> None:
        self.client.use_tracer(tracer)

    def connect(self) -> None:
        self.client.connect()

    def close(self) -> None:
        self.client.close()

    def health_check(self) -> dict:
        return self.client.health_check()

    def indices(self) -> list[str]:
        return sorted(self.client.list_collections())

    def create_index(self, index: str, settings: dict | None = None) -> None:
        self.client.create_collection(index)

    def index_document(self, index: str, id: str, document: dict) -> None:
        self.client.add(index, [{**document, "id": str(id)}], commit=True)

    def search(self, index: str, query: dict, size: int = 10) -> dict:
        q = query.get("query", query)
        text = q["match"]["_all"] if "match" in q else "*:*"
        docs = self.client.search(index, text, rows=size)["response"]
        return {"hits": {"total": {"value": docs["numFound"]},
                         "hits": [{"_id": str(d["id"]), "_source": d} for d in docs["docs"]]}}


def migrations(migrate_cls) -> dict:
    """Version 1 the wide-column tables, 2 the document collection, 3 the
    search index; each version is recorded by the migrators of the stores
    the app holds. ``migrate_cls`` is the package's ``Migrate``."""
    def tables(ds):
        for stmt in MIGRATIONS_TABLES:
            ds.widecolumn.exec(stmt)

    def collection(ds):
        ds.document.insert_one("jobs_meta", {"_id": "schema", "version": 2})

    def index(ds):
        if INDEX not in ds.search.indices():
            ds.search.create_index(INDEX)
    return {1: migrate_cls(up=tables), 2: migrate_cls(up=collection), 3: migrate_cls(up=index)}


def job_handler(engine, max_new_tokens: int = 32):
    """The ``POST /jobs/{id}`` handler. A sync handler: it runs on the app's
    executor and waits on the engine's future there. One document
    transaction at a time: the embedded store is single-writer, and the
    Mongo fake runs every session of a connection on that store."""
    txn_lock = threading.Lock()

    def handler(ctx):
        job_id = ctx.path_param("id")
        prompt = [int(t) for t in ctx.bind(dict)["prompt"]]
        wide, docs, search = (ctx.datasource(n) for n in ("widecolumn", "document", "search"))
        with ctx.trace("widecolumn.claim"):
            claimed = wide.exec_cas([], "INSERT INTO jobs (id, state) VALUES (?, ?) IF NOT EXISTS",
                                    job_id, "claimed")
        if not claimed:
            raise ErrorEntityAlreadyExist()
        with ctx.trace("kv.set"):
            ctx.kv_store.set(f"job:{job_id}", "running")
        with ctx.trace("engine.generate"):
            res = engine.submit(prompt, max_new_tokens=max_new_tokens,
                                temperature=0.0).result(timeout=600)
        tokens = list(res.token_ids)
        with txn_lock, ctx.trace("document.insert"):
            session = docs.start_session()
            with session.start_transaction():
                session.insert_one("jobs", {"_id": job_id, "prompt": prompt, "tokens": tokens,
                                            "ttft_ms": res.ttft_s * 1e3})
        batch = f"usage-{job_id}-{time.monotonic_ns()}"
        with ctx.trace("widecolumn.batch"):
            wide.new_batch(batch)
            wide.batch_query(batch, "INSERT INTO usage (id, prompt_tokens, new_tokens) "
                             "VALUES (?, ?, ?)", job_id, len(prompt), len(tokens))
            wide.batch_query(batch, "UPDATE jobs SET state = ? WHERE id = ?", "recorded", job_id)
            wide.execute_batch(batch)
        with ctx.trace("search.add"):
            search.index_document(INDEX, job_id, {"id": job_id, "text": job_text(tokens)})
        with ctx.trace("kv.set"):
            ctx.kv_store.set(f"job:{job_id}", "done")
        return {"id": job_id, "tokens": tokens}
    return handler


def search_handler(size: int = 10):
    """``GET /search?q=...``: the ids of the matching jobs, best first."""
    def handler(ctx):
        with ctx.trace("search.query"):
            hits = ctx.datasource("search").search(
                INDEX, {"query": {"match": {"_all": ctx.param("q")}}}, size=size)
        return {"ids": [h["_id"] for h in hits["hits"]["hits"]]}
    return handler


def build_app(config=None):
    from gofr_tpu_torch import serve
    from gofr_tpu_torch.datasource.document import new_document_store
    from gofr_tpu_torch.datasource.kv import DynamoDBKVStore, FileKVStore
    from gofr_tpu_torch.datasource.search import EmbeddedSearch
    from gofr_tpu_torch.datasource.search.solr import SolrClient
    from gofr_tpu_torch.datasource.timeseries import EmbeddedTimeSeries, TPUTelemetryRecorder
    from gofr_tpu_torch.datasource.tpu import new_tpu
    from gofr_tpu_torch.datasource.widecolumn import new_widecolumn_store
    from gofr_tpu_torch.migration import Migrate

    app = serve.build_app(config)  # the engine and the generation routes
    conf = app.container.config
    root = conf.get_or_default("DATA_ROOT", "./data")
    os.makedirs(root, exist_ok=True)
    app.add_tpu(new_tpu(conf, device=conf.get_or_default("SERVE_DEVICE", "cuda")))
    app.add_datasource("kv_store", DynamoDBKVStore.from_config(conf)
                       if conf.get("DYNAMODB_ENDPOINT") else
                       FileKVStore(os.path.join(root, "kv.json")))
    app.add_datasource("document", new_document_store(conf))
    app.add_datasource("widecolumn", new_widecolumn_store(conf))
    app.add_datasource("search", SolrIndex(SolrClient.from_config(conf))
                       if conf.get("SOLR_URL") else EmbeddedSearch())
    timeseries = EmbeddedTimeSeries.from_config(conf)
    app.add_datasource("timeseries", timeseries)
    recorder = TPUTelemetryRecorder(app.container.tpu, timeseries)
    app.add_cron_job("* * * * * *", "device-memory", recorder.sample)
    app.migrate(migrations(Migrate))
    app.post("/jobs/{id}", job_handler(app.container.serving))
    app.get("/search", search_handler())
    return app


if __name__ == "__main__":
    build_app().run()
