"""The slice as a whole: an ``App`` with ``DB_DIALECT=sqlite``, migrations,
the CRUD routes and a generation job recorded in SQL, on the port
(``gofr_tpu_torch``, a tiny engine on the CPU) beside the JAX package's
(a tiny JAX engine), at ``LlamaConfig.tiny(vocab_size=300)`` with the JAX
package's params carried across (``models/convert.py::params_from_jax``).

Each side migrates its own database file (version 1 the ``prompt`` and
``generation`` tables, version 2 the seeded prompts), serves
``add_rest_handlers(Prompt)`` and ``add_rest_handlers(Generation)``, and a
``POST /jobs/{id}`` handler that reads the prompt row through ``ctx.sql``,
generates greedily through the engine and writes the ``generation`` row in
one ``ctx.sql.begin()`` transaction. Compared with equality: each job's
tokens (and the port's equal to ``engine.submit`` of the same prompt), the
rows read back through the CRUD routes, and the versions. A restart on the
same files with a new version applies only that version."""

import dataclasses
import json
import random
import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gofr_tpu  # noqa: E402
from gofr_tpu import migration as rmig  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.http import errors as r_errors  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import handlers as r_handlers  # noqa: E402
from gofr_tpu_torch import migration as tmig  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.http import errors as t_errors  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app  # noqa: E402

CONF = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32), max_queue=64,
            prefill_chunk_tokens=32, kv_layout="paged", kv_page_size=8)
N_PROMPTS = 6
NEW_TOKENS = 8
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


@dataclasses.dataclass
class Prompt:
    id: int = 0
    text: str = ""
    max_new: int = 0


@dataclasses.dataclass
class Generation:
    id: int = 0
    prompt_id: int = 0
    tokens: str = ""
    text: str = ""


def _prompts() -> list[tuple[int, str, int]]:
    rng = random.Random(0)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "gpu", "sql"]
    return [(i, " ".join(rng.choice(words) for _ in range(rng.randint(1, 6))), NEW_TOKENS)
            for i in range(1, N_PROMPTS + 1)]


def _migrations(mig, ran: list, extra: dict | None = None) -> dict:
    def v1(ds):
        ran.append(1)
        ds.sql.exec("CREATE TABLE prompt (id INTEGER PRIMARY KEY, text TEXT, max_new INTEGER)")
        ds.sql.exec("CREATE TABLE generation (id INTEGER PRIMARY KEY AUTOINCREMENT, "
                    "prompt_id INTEGER, tokens TEXT, text TEXT)")

    def v2(ds):
        ran.append(2)
        for row in _prompts():
            ds.sql.exec("INSERT INTO prompt (id, text, max_new) VALUES (?, ?, ?)", *row)

    out = {1: mig.Migrate(up=v1), 2: mig.Migrate(up=v2)}
    out.update(extra or {})
    return out


def job_handler(engine, errors):
    """``POST /jobs/{id}``: the prompt row through ``ctx.sql``, greedy tokens
    from the engine, the ``generation`` row in one transaction. A sync
    handler: it runs on the app's executor, never on the engine thread."""
    def job(ctx):
        pid = int(ctx.path_param("id"))
        row = ctx.sql.query_row("SELECT text, max_new FROM prompt WHERE id = ?", pid)
        if row is None:
            raise errors.ErrorEntityNotFound("prompt", str(pid))
        res = engine.submit(row["text"], max_new_tokens=row["max_new"]).result(timeout=TIMEOUT)
        tx = ctx.sql.begin()
        try:
            cur = tx.exec("INSERT INTO generation (prompt_id, tokens, text) VALUES (?, ?, ?)",
                          pid, json.dumps(res.token_ids), res.text)
            tx.commit()
        except BaseException:
            tx.rollback()
            raise
        return {"prompt_id": pid, "generation_id": cur.lastrowid, "tokens": res.token_ids}
    return job


def _build(models, side: str, db_path: str, migrations: dict):
    jcfg, jparams, tcfg, tparams = models
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "HTTP_HOST": "127.0.0.1", "APP_NAME": f"sql-{side}", "LOG_LEVEL": "FATAL",
              "SHUTDOWN_GRACE_PERIOD": "5", "DB_DIALECT": "sqlite", "DB_NAME": db_path}
    if side == "ref":
        app = gofr_tpu.App(RMapConfig(values, use_env=False))
        engine = JServingEngine(jcfg, jparams, JEngineConfig(**CONF), JByteTokenizer())
        r_handlers.register_generation_routes(app, engine)
    else:
        app = TApp(TMapConfig(values, use_env=False))
        engine = ServingEngine(tcfg, tparams, EngineConfig(**CONF), ByteTokenizer(), device="cpu")
        t_handlers.register_generation_routes(app, engine)
    app.migrate(migrations)
    app.add_rest_handlers(Prompt)
    app.add_rest_handlers(Generation)
    app.post("/jobs/{id}", job_handler(engine, r_errors if side == "ref" else t_errors))
    return app, engine


def _ask(app, method: str, path: str):
    status, _, raw = fetch(f"http://127.0.0.1:{app.http_port}{path}", method, b"{}"
                           if method == "POST" else None, {"Content-Type": "application/json"},
                           timeout=TIMEOUT)
    return status, json.loads(raw) if raw else None


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    out = {}
    for side, mig in (("ref", rmig), ("port", tmig)):
        path = str(tmp_path_factory.mktemp(side) / "app.db")
        ran: list = []
        app, engine = _build(models, side, path, _migrations(mig, ran))
        out[side] = dict(app=app, engine=engine, path=path, ran=ran, thread=start_app(app))
    yield out
    for s in out.values():
        if s["thread"] is not None:
            stop_app(s["app"], s["thread"])


def _jobs(side: dict, concurrent: bool) -> dict[int, tuple[int, dict]]:
    """Every prompt's job, all at once (each on its own client thread) or one
    at a time."""
    replies: dict = {}
    threads = [threading.Thread(target=lambda i=i: replies.__setitem__(
        i, _ask(side["app"], "POST", f"/jobs/{i}"))) for i, _, _ in _prompts()]
    for t in threads:
        t.start()
        if not concurrent:
            t.join(TIMEOUT)
    for t in threads:
        t.join(TIMEOUT)
    return replies


def test_jobs_store_the_references_tokens_and_read_back_equal(served):
    # the reference's jobs go one at a time: its one shared sqlite connection
    # fails a second thread's BEGIN while a Tx is open (Queue C 42); the
    # port's lock makes the second wait
    replies = {name: _jobs(side, concurrent=name == "port") for name, side in served.items()}
    for i, text, _ in _prompts():
        (rs, rbody), (ts, tbody) = replies["ref"][i], replies["port"][i]
        assert rs == ts == 201, (rbody, tbody)
        assert tbody["data"]["tokens"] == rbody["data"]["tokens"]
        assert len(tbody["data"]["tokens"]) >= 1
        direct = served["port"]["engine"].submit(text, max_new_tokens=NEW_TOKENS).result(TIMEOUT)
        assert tbody["data"]["tokens"] == direct.token_ids
    rows = {}
    for name, side in served.items():
        status, body = _ask(side["app"], "GET", "/generation")
        assert status == 200
        rows[name] = sorted((g["prompt_id"], g["tokens"], g["text"]) for g in body["data"])
        for i, _, _ in _prompts():  # each row by id through CRUD equals the job's reply
            gid = replies[name][i][1]["data"]["generation_id"]
            status, one = _ask(side["app"], "GET", f"/generation/{gid}")
            assert status == 200 and one["data"]["prompt_id"] == i
            assert json.loads(one["data"]["tokens"]) == replies[name][i][1]["data"]["tokens"]
    assert rows["port"] == rows["ref"] and len(rows["port"]) == N_PROMPTS
    assert _ask(served["port"]["app"], "GET", "/prompt") == _ask(served["ref"]["app"], "GET",
                                                                 "/prompt")
    missing = _ask(served["port"]["app"], "POST", "/jobs/999")
    assert missing == _ask(served["ref"]["app"], "POST", "/jobs/999") and missing[0] == 404
    health = _ask(served["port"]["app"], "GET", "/.well-known/health")[1]["data"]
    assert health["details"]["sql"]["status"] == "UP"


def test_a_restart_applies_only_the_new_version(models, served):
    """Both apps stop; a new app on each file with versions 1, 2 and a new 3
    runs only 3, and the rows of the first run are still there."""
    before = {}
    for side in served.values():
        before[side["path"]] = _ask(side["app"], "GET", "/generation")[1]["data"]
        stop_app(side["app"], side["thread"])
        side["thread"] = None
    versions = {}
    for name, mig in (("ref", rmig), ("port", tmig)):
        side, ran = served[name], []

        def v3(ds, ran=ran):
            ran.append(3)
            ds.sql.exec("CREATE INDEX generation_prompt ON generation (prompt_id)")

        app, _ = _build(models, name, side["path"], _migrations(mig, ran, {3: mig.Migrate(up=v3)}))
        try:
            assert ran == [3]
            versions[name] = [(r["version"], r["method"]) for r in app.container.sql.query(
                "SELECT version, method FROM gofr_migration ORDER BY version")]
            rows = app.container.sql.query("SELECT * FROM generation ORDER BY id")
            assert [r["id"] for r in rows] == [g["id"] for g in sorted(before[side["path"]],
                                                                      key=lambda g: g["id"])]
        finally:
            app.container.close()
    assert versions["port"] == versions["ref"] == [(1, "UP"), (2, "UP"), (3, "UP")]
    assert served["port"]["ran"] == served["ref"]["ran"] == [1, 2]
