"""The slice as a whole: generation jobs claimed, logged, metered and indexed
through the KV, document, wide-column and search datasources, on the port
beside the JAX package, at ``LlamaConfig.tiny(vocab_size=300)`` with the JAX
package's params carried across (``models/convert.py::params_from_jax``).

Each app runs the ``POST /jobs/{id}`` and ``GET /search`` handlers and the
migrations of ``examples_torch/using-datastores`` over a paged engine with
int8 KV:

- ``ref``: the JAX package's ``App`` and engine over its embedded stores
  (``InMemoryKVStore``, ``EmbeddedDocumentStore``,
  ``EmbeddedWideColumnStore``, ``EmbeddedSearch``);
- ``port``: the port's, over its embedded stores, with a time-series store
  that a cron job fills from the port's ``TPUClient(device="cpu")``;
- ``port-wire``: the port's, over its wire clients on its fakes
  (``DynamoDBKVStore`` on ``MiniDynamoDBServer``, ``MongoClient`` on
  ``MiniMongoServer``, ``CassandraClient`` on ``MiniCassandraServer``, a
  ``SolrClient`` on ``MiniSolrServer`` behind the example's ``SolrIndex``).

Compared with equality, the same jobs in the same order: the greedy tokens
(the port's also equal to ``engine.submit`` of each prompt), the stored
documents (``ttft_ms`` aside), the usage and claim rows, the KV values, the
search rankings, the migrations' recorded versions, a duplicate's 409 with
nothing admitted, and with the document store down: a 5xx, the claim row
kept and ``job:<id>`` left ``"running"``. Health shows every family UP on
the port, then ``document`` DOWN."""

import importlib.util
import json
import pathlib
import random
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gofr_tpu  # noqa: E402
from gofr_tpu import migration as rmigration  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.datasource.document import EmbeddedDocumentStore as REmbeddedDocumentStore  # noqa: E402
from gofr_tpu.datasource.kv import InMemoryKVStore as RInMemoryKVStore  # noqa: E402
from gofr_tpu.datasource.search import EmbeddedSearch as REmbeddedSearch  # noqa: E402
from gofr_tpu.datasource.timeseries import EmbeddedTimeSeries as REmbeddedTimeSeries  # noqa: E402
from gofr_tpu.datasource.widecolumn import EmbeddedWideColumnStore as REmbeddedWideColumnStore  # noqa: E402,E501
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch import migration as tmigration  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.datasource.document import EmbeddedDocumentStore  # noqa: E402
from gofr_tpu_torch.datasource.document.mongo import MongoClient  # noqa: E402
from gofr_tpu_torch.datasource.kv import DynamoDBKVStore, InMemoryKVStore  # noqa: E402
from gofr_tpu_torch.datasource.search import EmbeddedSearch  # noqa: E402
from gofr_tpu_torch.datasource.search.solr import SolrClient  # noqa: E402
from gofr_tpu_torch.datasource.timeseries import EmbeddedTimeSeries, TPUTelemetryRecorder  # noqa: E402
from gofr_tpu_torch.datasource.tpu import TPUClient  # noqa: E402
from gofr_tpu_torch.datasource.widecolumn import EmbeddedWideColumnStore  # noqa: E402
from gofr_tpu_torch.datasource.widecolumn.cassandra import CassandraClient  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import (  # noqa: E402
    MiniCassandraServer, MiniDynamoDBServer, MiniMongoServer, MiniSolrServer, fetch,
    get_free_port, start_app, stop_app)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32), max_queue=64,
            prefill_chunk_tokens=32, kv_layout="paged", kv_page_size=8, kv_dtype="int8")
NEW_TOKENS = 8
TIMEOUT = 120
SIDES = ("ref", "port", "port-wire")


def _example():
    spec = importlib.util.spec_from_file_location(
        "using_datastores", ROOT / "examples_torch" / "using-datastores" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLE = _example()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(seed: int, n: int) -> list[list[int]]:
    rng = random.Random(seed)
    return [[rng.randrange(3, 300) for _ in range(rng.randint(2, 20))] for _ in range(n)]


PROMPTS = _prompts(0, 6)
JOB_IDS = [f"job-{i}" for i in range(len(PROMPTS))]


class CountingEngine:
    """The engine the handler sees: ``submit`` counted, all else passed on."""

    def __init__(self, engine) -> None:
        self.engine, self.submitted = engine, 0

    def submit(self, *args, **kw):
        self.submitted += 1
        return self.engine.submit(*args, **kw)


@pytest.fixture(scope="module")
def served():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    fakes = {"dynamo": MiniDynamoDBServer().start(), "mongo": MiniMongoServer().start(),
             "cassandra": MiniCassandraServer().start(), "solr": MiniSolrServer()}
    out = {}
    for side in SIDES:
        values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
                  "HTTP_HOST": "127.0.0.1", "APP_NAME": f"stores-{side}", "LOG_LEVEL": "FATAL",
                  "SHUTDOWN_GRACE_PERIOD": "5"}
        if side == "ref":
            app = gofr_tpu.App(RMapConfig(values, use_env=False))
            engine = JServingEngine(jcfg, jparams, JEngineConfig(**CONF), JByteTokenizer())
            stores = {"kv_store": RInMemoryKVStore(), "document": REmbeddedDocumentStore(),
                      "widecolumn": REmbeddedWideColumnStore(), "search": REmbeddedSearch(),
                      "timeseries": REmbeddedTimeSeries()}
            migrate = rmigration.Migrate
        else:
            app = TApp(TMapConfig(values, use_env=False))
            engine = ServingEngine(tcfg, tparams, EngineConfig(**CONF), ByteTokenizer(),
                                   device="cpu")
            migrate = tmigration.Migrate
            if side == "port":
                stores = {"kv_store": InMemoryKVStore(), "document": EmbeddedDocumentStore(),
                          "widecolumn": EmbeddedWideColumnStore(), "search": EmbeddedSearch()}
            else:
                dyn = fakes["dynamo"]
                stores = {
                    "kv_store": DynamoDBKVStore("kv", endpoint=dyn.endpoint, region=dyn.region,
                                                access_key=dyn.access_key,
                                                secret_key=dyn.secret_key),
                    "document": MongoClient(host="127.0.0.1", port=fakes["mongo"].port),
                    "widecolumn": CassandraClient(host="127.0.0.1", port=fakes["cassandra"].port),
                    "search": EXAMPLE.SolrIndex(SolrClient(fakes["solr"].url))}
            stores["timeseries"] = EmbeddedTimeSeries()
            app.add_tpu(TPUClient(device="cpu"))
            recorder = TPUTelemetryRecorder(app.container.tpu, stores["timeseries"])
            app.add_cron_job("* * * * * *", "device-memory", recorder.sample)
        for name, store in stores.items():
            app.add_datasource(name, store)
        app.migrate(EXAMPLE.migrations(migrate))
        counted = CountingEngine(engine)
        app.post("/jobs/{id}", EXAMPLE.job_handler(counted, max_new_tokens=NEW_TOKENS))
        app.get("/search", EXAMPLE.search_handler())
        engine.start()
        out[side] = dict(app=app, engine=engine, counted=counted, stores=stores, fakes=fakes,
                         thread=start_app(app))
    yield out
    for s in out.values():
        stop_app(s["app"], s["thread"])
        s["engine"].stop()
    for fake in fakes.values():
        fake.close()


def _call(side: dict, method: str, path: str, body=None):
    status, _, raw = fetch(f"http://127.0.0.1:{side['app'].http_port}{path}", method,
                           None if body is None else json.dumps(body).encode(),
                           {"Content-Type": "application/json"}, timeout=TIMEOUT)
    return status, json.loads(raw)


def _state(side: dict, ids: list[str]) -> dict:
    stores = side["stores"]
    docs = [stores["document"].find_one("jobs", {"_id": i}) for i in ids]
    wide = stores["widecolumn"]
    return {
        "documents": [None if d is None else {k: v for k, v in d.items() if k != "ttft_ms"}
                      for d in docs],
        "ttft_ms_positive": [d is None or d["ttft_ms"] > 0 for d in docs],
        "usage": sorted(tuple(r.values()) for r in wide.query(
            [], "SELECT id, prompt_tokens, new_tokens FROM usage")),
        "claims": sorted(tuple(r.values()) for r in wide.query([], "SELECT id, state FROM jobs")),
        "kv": [_kv(stores["kv_store"], f"job:{i}") for i in ids],
        "migrations": {
            "document": sorted(int(d["version"]) for d in stores["document"].find(
                "gofr_migration", {})),
            "widecolumn": sorted(int(r["version"]) for r in wide.query(
                [], "SELECT version FROM gofr_migration")),
            "search": sorted(h["_id"] for h in stores["search"].search(
                "gofr_migration", {}, size=10)["hits"]["hits"])},
    }


def _kv(kv, key: str):
    try:
        return kv.get(key)
    except KeyError:
        return None


def test_jobs_give_the_references_tokens_records_and_rankings(served):
    replies = {name: [_call(side, "POST", f"/jobs/{i}", {"prompt": p})
                      for i, p in zip(JOB_IDS, PROMPTS)] for name, side in served.items()}
    for name in SIDES:
        assert all(status == 201 for status, _ in replies[name]), (name, replies[name])
    assert replies["port"] == replies["port-wire"] == replies["ref"]
    engine = served["port"]["engine"]
    for p, (_, body) in zip(PROMPTS, replies["port"]):
        direct = engine.submit(p, max_new_tokens=NEW_TOKENS, temperature=0.0).result(TIMEOUT)
        assert body["data"]["tokens"] == direct.token_ids and len(direct.token_ids) >= 1
    states = {name: _state(side, JOB_IDS) for name, side in served.items()}
    assert states["port"] == states["port-wire"] == states["ref"]
    state = states["port"]
    assert state["kv"] == ["done"] * len(JOB_IDS)
    assert state["claims"] == [(i, "recorded") for i in JOB_IDS]
    assert state["usage"] == [(i, len(p), NEW_TOKENS) for i, p in zip(JOB_IDS, PROMPTS)]
    assert all(state["ttft_ms_positive"])
    assert state["migrations"] == {"document": [1, 2, 3], "widecolumn": [1, 2, 3],
                                   "search": ["1", "2", "3"]}
    # rankings for tokens of the replies, from the app and from a host index
    host = EmbeddedSearch()
    for i, (_, body) in zip(JOB_IDS, replies["port"]):
        host.index_document("jobs", i, {"id": i, "text": EXAMPLE.job_text(body["data"]["tokens"])})
    toks = sorted({t for _, body in replies["port"] for t in body["data"]["tokens"]})[:5]
    for tok in toks:
        ranked = {name: _call(side, "GET", f"/search?q=t{tok}") for name, side in served.items()}
        want = [h["_id"] for h in host.search(
            "jobs", {"query": {"match": {"_all": f"t{tok}"}}})["hits"]["hits"]]
        assert ranked["port"] == ranked["port-wire"] == ranked["ref"] == (200, {"data": {
            "ids": want}}), tok
        assert want


def test_a_duplicate_is_a_409_that_admits_nothing(served):
    got = {}
    for name, side in served.items():
        before = side["counted"].submitted
        status, body = _call(side, "POST", f"/jobs/{JOB_IDS[0]}", {"prompt": PROMPTS[0]})
        got[name] = (status, side["counted"].submitted - before)
    assert got == {name: (409, 0) for name in SIDES}


def test_health_shows_every_family_up_and_the_cron_records_the_device(served):
    for name in ("port", "port-wire"):
        side = served[name]
        status, body = _call(side, "GET", "/.well-known/health")
        details = body["data"]["details"]
        assert status == 200, body
        for family in ("kv_store", "document", "widecolumn", "search", "timeseries", "tpu"):
            assert details[family]["status"] == "UP", (name, family, details[family])
        c = side["app"].container
        assert c.kv_store is side["stores"]["kv_store"]
        assert c.extra_datasources["document"] is side["stores"]["document"]
        ts = side["stores"]["timeseries"]
        deadline = time.monotonic() + 10
        while not ts.query("tpu", "hbm_bytes_in_use") and time.monotonic() < deadline:
            time.sleep(0.1)
        rows = ts.query("tpu", "hbm_bytes_in_use")
        assert rows and rows[0]["tags"]["kind"] == c.tpu.hbm_stats()["devices"][0]["kind"]


def test_a_down_document_store_is_a_5xx_that_leaves_the_claim_running(served):
    """Runs last: it stops each side's document store."""
    got = {}
    for name, side in served.items():
        if name == "port-wire":
            side["fakes"]["mongo"].close()  # its connections drop (Queue C 56)
        else:
            side["stores"]["document"].close()
        before = side["counted"].submitted
        status, _ = _call(side, "POST", "/jobs/late", {"prompt": PROMPTS[1]})
        claims = side["stores"]["widecolumn"].query([], "SELECT state FROM jobs WHERE id = ?",
                                                    "late")
        got[name] = (status, side["counted"].submitted - before, claims,
                     _kv(side["stores"]["kv_store"], "job:late"))
        health = _call(side, "GET", "/.well-known/health")[1]["data"]["details"]
        assert health["document"]["status"] == "DOWN", (name, health["document"])
    assert got == {name: (500, 1, [{"state": "claimed"}], "running") for name in SIDES}
