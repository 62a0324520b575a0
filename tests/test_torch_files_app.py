"""The slice as a whole: generation jobs read from files through ``ctx.file``,
their results cached in Redis through ``ctx.redis``, on the port beside the
JAX package, at ``LlamaConfig.tiny(vocab_size=300)`` with the JAX package's
params carried across (``models/convert.py::params_from_jax``).

Each app runs the ``POST /batch/{name}`` handler of
``examples_torch/using-file-jobs`` (with its own package's
``JSONRowReader``) over the same ``jobs.jsonl``:

- ``ref``: the JAX package's ``App`` and engine, its ``InMemoryRedis`` and
  ``LocalFileSystem``;
- ``port``: the port's, with its ``InMemoryRedis`` and ``LocalFileSystem``;
- ``port-wire``: the port's, with its ``RedisClient`` on its RESP2 server and
  an ``ObjectFileSystem`` over S3 on its ``FakeObjectStore``.

Compared with equality: the greedy tokens (and the port's equal to
``engine.submit`` of each prompt), the ``results.jsonl`` bytes, the Redis
keys and values, and the hits and misses of a second pass and of a file with
one new prompt. Health shows ``redis`` and ``file`` UP on the port."""

import importlib.util
import json
import pathlib
import random

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gofr_tpu  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.datasource.file import JSONRowReader as RJSONRowReader  # noqa: E402
from gofr_tpu.datasource.file import LocalFileSystem as RLocalFileSystem  # noqa: E402
from gofr_tpu.datasource.redis import InMemoryRedis as RInMemoryRedis  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.datasource.file import (  # noqa: E402
    JSONRowReader, LocalFileSystem, ObjectFileSystem, S3Provider)
from gofr_tpu_torch.datasource.redis import InMemoryRedis, RedisClient  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import (  # noqa: E402
    FakeObjectStore, MiniRedisServer, fetch, get_free_port, start_app, stop_app)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32), max_queue=64,
            prefill_chunk_tokens=32, kv_layout="paged", kv_page_size=8)
NEW_TOKENS = 8
TIMEOUT = 120
SIDES = ("ref", "port", "port-wire")


def _example():
    spec = importlib.util.spec_from_file_location(
        "using_file_jobs", ROOT / "examples_torch" / "using-file-jobs" / "main.py")
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
JOBS = "".join(json.dumps({"prompt": p}) + "\n" for p in PROMPTS + PROMPTS[:2])
NEW_PROMPT = _prompts(1, 1)[0]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    fake, redis_server = FakeObjectStore(), MiniRedisServer()
    out = {}
    for side in SIDES:
        values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
                  "HTTP_HOST": "127.0.0.1", "APP_NAME": f"files-{side}", "LOG_LEVEL": "FATAL",
                  "SHUTDOWN_GRACE_PERIOD": "5"}
        root = tmp_path_factory.mktemp(side)
        if side == "ref":
            app = gofr_tpu.App(RMapConfig(values, use_env=False))
            engine = JServingEngine(jcfg, jparams, JEngineConfig(**CONF), JByteTokenizer())
            redis, fs, rows = RInMemoryRedis(), RLocalFileSystem(str(root)), RJSONRowReader
        else:
            app = TApp(TMapConfig(values, use_env=False))
            engine = ServingEngine(tcfg, tparams, EngineConfig(**CONF), ByteTokenizer(),
                                   device="cpu")
            rows = JSONRowReader
            if side == "port":
                redis, fs = InMemoryRedis(), LocalFileSystem(str(root))
            else:
                redis = RedisClient(host="127.0.0.1", port=redis_server.port)
                fs = ObjectFileSystem(S3Provider(
                    "test-bucket", endpoint=fake.s3_endpoint, region=fake.region,
                    access_key=fake.access_key, secret_key=fake.secret_key), name="s3")
        app.add_datasource("redis", redis)
        app.add_datasource("file", fs)
        app.post("/batch/{name}", EXAMPLE.batch_handler(engine, rows=rows,
                                                         max_new_tokens=NEW_TOKENS))
        engine.start()
        fs.mkdir("demo")
        with fs.create("demo/jobs.jsonl") as f:
            f.write(JOBS.encode())
        out[side] = dict(app=app, engine=engine, redis=redis, fs=fs, thread=start_app(app))
    yield out
    for s in out.values():
        stop_app(s["app"], s["thread"])
        s["engine"].stop()
    redis_server.close()
    fake.close()


def _post(side: dict, path: str):
    status, _, raw = fetch(f"http://127.0.0.1:{side['app'].http_port}{path}", "POST", b"{}",
                           {"Content-Type": "application/json"}, timeout=TIMEOUT)
    return status, json.loads(raw)


def _read(side: dict, name: str) -> bytes:
    fs = side["fs"]  # the JAX package's local open() takes no mode (Queue C 51)
    with (fs.open(name) if isinstance(fs, RLocalFileSystem) else fs.open(name, "rb")) as f:
        return f.read()


def _redis_state(side: dict) -> dict:
    return {EXAMPLE.job_key(p): side["redis"].get(EXAMPLE.job_key(p))
            for p in PROMPTS + [NEW_PROMPT]}


def test_batches_give_the_references_tokens_results_and_cache(served):
    first = {name: _post(side, "/batch/demo") for name, side in served.items()}
    for name in SIDES:
        assert first[name] == (201, {"data": {"jobs": 8, "misses": 6}}), (name, first[name])
    results = {name: _read(side, "demo/results.jsonl") for name, side in served.items()}
    assert results["port"] == results["port-wire"] == results["ref"]
    rows = [json.loads(line) for line in results["port"].decode().splitlines()]
    assert [r["prompt"] for r in rows] == PROMPTS + PROMPTS[:2]
    engine = served["port"]["engine"]
    for r in rows:
        direct = engine.submit(r["prompt"], max_new_tokens=NEW_TOKENS).result(TIMEOUT)
        assert r["tokens"] == direct.token_ids and len(r["tokens"]) >= 1
    states = {name: _redis_state(side) for name, side in served.items()}
    assert states["port"] == states["port-wire"] == states["ref"]
    assert sum(v is not None for v in states["port"].values()) == 6
    # a second pass is all hits and writes the same bytes
    again = {name: _post(side, "/batch/demo") for name, side in served.items()}
    assert all(a == (201, {"data": {"jobs": 8, "misses": 0}}) for a in again.values()), again
    assert {name: _read(side, "demo/results.jsonl") for name, side in served.items()} == results
    # one new prompt beside the cached ones: one miss
    for side in served.values():
        side["fs"].mkdir("more")
        with side["fs"].create("more/jobs.jsonl") as f:
            f.write((JOBS + json.dumps({"prompt": NEW_PROMPT}) + "\n").encode())
    more = {name: _post(side, "/batch/more") for name, side in served.items()}
    assert all(m == (201, {"data": {"jobs": 9, "misses": 1}}) for m in more.values()), more
    assert len({_read(side, "more/results.jsonl") for side in served.values()}) == 1
    states = {name: _redis_state(side) for name, side in served.items()}
    assert states["port"] == states["port-wire"] == states["ref"]
    assert all(v is not None for v in states["port"].values())
    wire_ttl = served["port-wire"]["redis"].ttl(EXAMPLE.job_key(NEW_PROMPT))
    assert 0 < wire_ttl <= 600.0


def test_health_shows_redis_and_file_and_ctx_reads_the_slots(served):
    for name in ("port", "port-wire"):
        app = served[name]["app"]
        status, _, raw = fetch(f"http://127.0.0.1:{app.http_port}/.well-known/health", "GET",
                               None, {}, timeout=TIMEOUT)
        details = json.loads(raw)["data"]["details"]
        assert status == 200 and details["redis"]["status"] == "UP", details
        assert details["file"]["status"] == "UP", details
        c = app.container
        assert (c.redis, c.file) == (served[name]["redis"], served[name]["fs"])
