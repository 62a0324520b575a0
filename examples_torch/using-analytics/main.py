"""Generation jobs whose usage is metered in ClickHouse and whose lineage
(tenant → job → result) lives in the graph datasource (an example of the
PyTorch port; the JAX package has no counterpart).

``POST /jobs/{id}`` with ``{"prompt": [token ids], "tenant": "name"}``:

1. submits the prompt (greedy) and waits for its tokens;
2. writes the job's usage row ``{job, tenant, prompt_tokens, new_tokens,
   ttft_ms}`` into the ``usage`` table with ``insert_rows`` (JSONEachRow);
3. writes one ``job_events`` row ``(job, tenant, kind)`` with
   ``async_insert`` (server-side parameters, buffered by the server);
4. links tenant → job → result in the graph inside one ``GraphTxn``: the
   tenant's node is made on its first job and reused after;
5. replies ``{"id", "tenant", "tokens", "completion_tokens"}``.

``GET /usage`` aggregates the new tokens and jobs per tenant in ClickHouse;
``GET /lineage/{tenant}`` expands the tenant's jobs and their results from
the graph. Each step runs in a span of its own (``engine.generate``,
``columnar.insert``, ``columnar.async_insert``, ``graph.txn``,
``columnar.select``, ``graph.query``).

The handlers take any ``ClickHouseClient``-shaped columnar store and any
``EmbeddedGraph``-shaped graph. Run it from its directory, ``cd
examples_torch/using-analytics && python main.py``: the app reads
``configs/.env`` there (a tiny model on the CPU and ``CLICKHOUSE_FAKE=1``,
which starts the package's ``MiniClickHouseServer`` on 127.0.0.1 and points
the client at it; without it the client goes to ``CLICKHOUSE_URL``), then
``curl -X POST localhost:8000/jobs/a -d '{"prompt": [5, 6, 7], "tenant":
"acme"}'``, ``curl localhost:8000/usage`` and ``curl
localhost:8000/lineage/acme``."""

import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# the tables, in the SQL both ClickHouse (with its default_table_engine)
# and the sqlite-backed fake accept
TABLES = (
    "CREATE TABLE IF NOT EXISTS usage (job String, tenant String, prompt_tokens UInt32, "
    "new_tokens UInt32, ttft_ms Float64)",
    "CREATE TABLE IF NOT EXISTS job_events (job String, tenant String, kind String)",
)
USAGE_BY_TENANT = ("SELECT tenant, sum(new_tokens) AS new_tokens, count(*) AS jobs "
                   "FROM usage GROUP BY tenant ORDER BY tenant")
EVENT = "INSERT INTO job_events (job, tenant, kind) VALUES ({job:String}, {tenant:String}, {kind:String})"
LINEAGE = {"runs": {"expand": {"produced": {}}}}


def create_tables(columnar) -> None:
    for stmt in TABLES:
        columnar.exec(stmt)


def job_handler(engine, max_new_tokens: int = 32):
    """The ``POST /jobs/{id}`` handler. A sync handler: it runs on the app's
    executor and waits on the engine's future there. The graph's lookup of a
    tenant's node and its commit run under one lock, so two first jobs of a
    tenant make one node."""
    graph_lock = threading.Lock()

    def handler(ctx):
        job_id = ctx.path_param("id")
        body = ctx.bind(dict)
        prompt = [int(t) for t in body["prompt"]]
        tenant = str(body.get("tenant", "default"))
        columnar, graph = ctx.datasource("columnar"), ctx.datasource("graph")
        with ctx.trace("engine.generate"):
            res = engine.submit(prompt, max_new_tokens=max_new_tokens,
                                temperature=0.0).result(timeout=600)
        tokens = list(res.token_ids)
        with ctx.trace("columnar.insert"):
            columnar.insert_rows("usage", [{
                "job": job_id, "tenant": tenant, "prompt_tokens": len(prompt),
                "new_tokens": res.completion_tokens, "ttft_ms": res.ttft_s * 1e3}])
        with ctx.trace("columnar.async_insert"):
            columnar.async_insert(EVENT, {"job": job_id, "tenant": tenant, "kind": "generated"})
        with graph_lock, ctx.trace("graph.txn"):
            known = graph.query(func={"eq": ["tenant", tenant]})
            tenant_uid = known[0]["uid"] if known else "_:tenant"
            txn = graph.new_txn()
            txn.mutate(set=[
                {"uid": tenant_uid, "tenant": tenant, "runs": {"uid": "_:job"}},
                {"uid": "_:job", "job": job_id, "new_tokens": res.completion_tokens,
                 "produced": {"uid": "_:result"}},
                {"uid": "_:result", "result": job_id, "tokens": " ".join(map(str, tokens))},
            ])
            txn.commit()
        return {"id": job_id, "tenant": tenant, "tokens": tokens,
                "completion_tokens": res.completion_tokens}
    return handler


def usage_handler():
    """``GET /usage``: ``{tenant: {"new_tokens", "jobs"}}`` from ClickHouse."""
    def handler(ctx):
        with ctx.trace("columnar.select"):
            rows = ctx.datasource("columnar").select(dict, USAGE_BY_TENANT)
        return {r["tenant"]: {"new_tokens": int(r["new_tokens"]), "jobs": int(r["jobs"])}
                for r in rows}
    return handler


def lineage_handler():
    """``GET /lineage/{tenant}``: the tenant's jobs and their results."""
    def handler(ctx):
        tenant = ctx.path_param("tenant")
        with ctx.trace("graph.query"):
            found = ctx.datasource("graph").query(func={"eq": ["tenant", tenant]},
                                                  expand=LINEAGE)
        jobs = [{"job": j["job"], "new_tokens": j["new_tokens"],
                 "results": [r["result"] for r in j.get("produced", [])]}
                for t in found for j in t.get("runs", [])]
        return {"tenant": tenant, "jobs": sorted(jobs, key=lambda j: j["job"])}
    return handler


def register(app, engine, max_new_tokens: int = 32) -> None:
    """The tables, then the three routes over ``engine``."""
    create_tables(app.container.extra_datasources["columnar"])
    app.post("/jobs/{id}", job_handler(engine, max_new_tokens))
    app.get("/usage", usage_handler())
    app.get("/lineage/{tenant}", lineage_handler())


def build_app(config=None):
    from gofr_tpu_torch import serve
    from gofr_tpu_torch.datasource.columnar import ClickHouseClient
    from gofr_tpu_torch.datasource.graph import EmbeddedGraph

    app = serve.build_app(config)  # the engine and the generation routes
    conf = app.container.config
    columnar = ClickHouseClient.from_config(conf)
    if conf.get_or_default("CLICKHOUSE_FAKE", "0") == "1":
        from gofr_tpu_torch.testutil import MiniClickHouseServer

        fake = MiniClickHouseServer()
        columnar.url = fake.url
        app.on_shutdown(fake.close)
    app.add_datasource("columnar", columnar)
    app.add_datasource("graph", EmbeddedGraph.from_config(conf))
    register(app, app.container.serving)
    return app


if __name__ == "__main__":
    build_app().run()
