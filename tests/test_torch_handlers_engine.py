"""The generation routes over real sockets: a JAX ``App`` with a tiny JAX
engine beside a port ``App`` with a tiny port engine (``device="cpu"``), on
the dense and the paged layouts, at ``LlamaConfig.tiny`` (vocab 300, the JAX
package's params carried across). Both sides get the same requests and must
agree on ``/generate``'s greedy text and usage; the SSE frames of
``/generate/stream`` (the ``id:`` sequence, token frames, the terminal
usage; the tokens equal to ``engine.submit``'s); ``/generate/cancel``; the
400s; a 429 shed and a 504 expiry (on engines held unstarted); the
``Last-Event-ID`` re-attach; the ``/requestz`` shape; ``/kv/fetch`` entries
that decode to equal slabs within 1e-4 at f32; and the set of ``/metrics``
families."""

import json
import threading
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gofr_tpu  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import handlers as r_handlers  # noqa: E402
from gofr_tpu.serving import prefix_index as r_pi  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as t_pi  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app  # noqa: E402

BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
            prefill_chunk_tokens=16, prefix_cache_entries=64)
LAYOUT_KW = {"dense": {}, "paged": dict(kv_layout="paged", kv_page_size=8)}
PROMPTS = ["hi", "the quick brown fox", "a prompt longer than every bucket we have"]
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


def _build(models, side, layout, start=True, **kw):
    """(app, engine) of one side: the engine on the app's metrics, tracer
    and logger, the generation routes registered."""
    jcfg, jparams, tcfg, tparams = models
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "HTTP_HOST": "127.0.0.1", "APP_NAME": f"{side}-{layout}", "LOG_LEVEL": "FATAL",
              "SHUTDOWN_GRACE_PERIOD": "5"}
    conf = {**BASE, **LAYOUT_KW[layout], **kw}
    if side == "ref":
        app = gofr_tpu.App(RMapConfig(values, use_env=False))
        engine = JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer(),
                                metrics=app.container.metrics_manager,
                                tracer=app.container.tracer, logger=app.logger)
        r_handlers.register_generation_routes(app, engine)
    else:
        app = TApp(TMapConfig(values, use_env=False))
        engine = ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(),
                               device="cpu", metrics=app.container.metrics_manager,
                               tracer=app.container.tracer, logger=app.logger)
        t_handlers.register_generation_routes(app, engine)
    if not start:
        app._on_start_hooks.clear()  # the engine stays unstarted: requests queue
    return app, engine


@pytest.fixture(scope="module", params=["dense", "paged"])
def served(request, models):
    out = {}
    for side in ("ref", "port"):
        app, engine = _build(models, side, request.param)
        out[side] = (app, engine, start_app(app))
    yield request.param, out
    for app, _, thread in out.values():
        stop_app(app, thread)


def _url(app, path):
    return f"http://127.0.0.1:{app.http_port}{path}"


def _post(app, path, payload, headers=None, raw=None):
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    body = raw if raw is not None else json.dumps(payload).encode()
    status, h, data = fetch(_url(app, path), "POST", body, hdrs, timeout=TIMEOUT)
    return status, h, json.loads(data) if data else None


def sse(app, payload, headers=None, keep=None):
    """The frames of one ``/generate/stream`` as (id or None, data) pairs;
    with ``keep`` the socket is closed after that many frames."""
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(_url(app, "/generate/stream"), json.dumps(payload).encode(),
                                 hdrs, method="POST")
    frames, seq = [], None
    resp = urllib.request.urlopen(req, timeout=TIMEOUT)
    try:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("id:"):
                seq = int(line[3:])
            elif line.startswith("data:"):
                data = line[5:].strip()
                frames.append((seq, data if data == "[DONE]" else json.loads(data)))
                seq = None
                if keep is not None and len(frames) >= keep:
                    break
    finally:
        resp.close()
    return frames


def _strip_ids(frames):
    return [(seq, {k: v for k, v in d.items() if k != "id"} if isinstance(d, dict) else d)
            for seq, d in frames]


def test_generate_greedy(served):
    _, sides = served
    got = {}
    for side, (app, _, _) in sides.items():
        rows = []
        for p in PROMPTS:
            status, _, body = _post(app, "/generate", {"prompt": p, "max_tokens": 6})
            data = body["data"]
            rows.append((status, data["text"], data["finish_reason"],
                         data["usage"]["prompt_tokens"], data["usage"]["completion_tokens"]))
        got[side] = rows
    assert got["port"] == got["ref"]
    assert all(r[0] == 201 and r[4] == 6 for r in got["port"])


def test_sse_frames_match_submit(served):
    _, sides = served
    got = {}
    for side, (app, engine, _) in sides.items():
        rows = []
        for p in PROMPTS:
            frames = sse(app, {"prompt": p, "max_tokens": 5})
            assert "id" in frames[0][1] and frames[0][0] == 0
            ids = [d["token"] for _, d in frames if isinstance(d, dict) and "token" in d]
            want = engine.submit(p, max_new_tokens=5, temperature=0.0).result(timeout=TIMEOUT)
            assert ids == list(want.token_ids)
            rows.append(_strip_ids(frames))
        got[side] = rows
    assert got["port"] == got["ref"]
    for frames in got["port"]:
        assert [s for s, _ in frames[:-1]] == list(range(len(frames) - 1))
        assert frames[-2][1]["finish_reason"] == "length"
        assert frames[-2][1]["usage"]["completion_tokens"] == 5 and frames[-1][1] == "[DONE]"


def test_cancel_mid_stream(served):
    _, sides = served
    got = {}
    for side, (app, engine, _) in sides.items():
        req = urllib.request.Request(
            _url(app, "/generate/stream"),
            json.dumps({"prompt": "cancel me please", "max_tokens": 100}).encode(),
            {"Content-Type": "application/json"}, method="POST")
        resp = urllib.request.urlopen(req, timeout=TIMEOUT)
        lines = iter(resp)
        head = None
        for raw in lines:
            if raw.startswith(b"data:"):
                head = json.loads(raw[5:])
                break
        status, _, body = _post(app, "/generate/cancel", {"id": head["id"]})
        finish = None
        for raw in lines:
            if raw.startswith(b"data:") and b"finish_reason" in raw:
                finish = json.loads(raw[5:])["finish_reason"]
        resp.close()
        bad = [_post(app, "/generate/cancel", {})[::2], _post(app, "/generate/cancel",
                                                              {"id": "x"})[::2],
               _post(app, "/generate/cancel", {"id": 10 ** 9})[0]]
        got[side] = (status, body["data"]["canceled"] == head["id"], finish, bad)
    assert got["port"] == got["ref"]
    assert got["port"][2] == "cancel"


BAD = [
    ({"max_tokens": 3}, None, None),
    ({"prompt": "x", "temperature": -1}, None, None),
    ({"prompt": "x", "top_p": 0}, None, None),
    ({"prompt": "x"}, {"X-Request-Timeout": "soon"}, None),
    ({"prompt": "x"}, {"X-Fence-Epoch": "first"}, None),
    (None, None, b"{not json"),
    ({"prompt": ""}, None, None),
]


@pytest.mark.parametrize("i", range(len(BAD)))
@pytest.mark.parametrize("path", ["/generate", "/generate/stream"])
def test_bad_requests_are_400(served, i, path):
    _, sides = served
    payload, headers, raw = BAD[i]
    got = {side: _post(app, path, payload, headers, raw)[::2]
           for side, (app, _, _) in sides.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0] == 400


def test_requestz_shape(served):
    _, sides = served
    got = {}
    for side, (app, _, _) in sides.items():
        rid = _post(app, "/generate", {"prompt": "requestz view", "max_tokens": 3})[2]["data"]["id"]
        # the terminal mark lands on the detok worker just after the
        # result: wait for it
        deadline = time.monotonic() + 30
        while True:
            one = json.loads(fetch(_url(app, f"/requestz/{rid}"))[2])["data"]
            if one["terminal"] or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        status, _, body = fetch(_url(app, "/requestz?limit=2"))
        snap = json.loads(body)["data"]
        errs = [fetch(_url(app, p))[0] for p in ("/requestz?limit=x", "/requestz/abc",
                                                 "/requestz/999999")]
        got[side] = (status, sorted(snap), len(snap["completed"]) <= 2, sorted(one),
                     one["request_id"] == rid, errs)
    assert got["port"] == got["ref"]


def test_kv_fetch_slabs(served):
    """Both sides served the same prompts: the same keys are advertised, and
    each side's ``/kv/fetch`` entries decode (with its own codec) to slabs
    equal within 1e-4."""
    _, sides = served
    decoded, keys = {}, {}
    for side, (app, engine, _) in sides.items():
        # the keys these two prompts add (what earlier tests left in the
        # cache depends on where their cancels landed)
        before = {k for k, _ in engine.prefix_advertisement()}
        _post(app, "/generate", {"prompt": "fetch this prefix please, all of it", "max_tokens": 2})
        _post(app, "/generate", {"prompt": "short one", "max_tokens": 2})
        keys[side] = sorted({k for k, _ in engine.prefix_advertisement()} - before)
    assert keys["port"] == keys["ref"] and keys["port"]
    for side, (app, _, _) in sides.items():
        status, _, body = _post(app, "/kv/fetch", {"keys": keys[side] + ["absent-key"]})
        assert status == 201
        entries = body["data"]["entries"]
        assert sorted(entries) == keys[side]
        codec = r_pi if side == "ref" else t_pi
        decoded[side] = {k: [(torch.tensor(jax.device_get(x).copy()) if side == "ref" else x)
                             .float() for x in codec.decode_entry(v)]
                         for k, v in entries.items()}
    for key in keys["port"]:
        for a, b in zip(decoded["port"][key], decoded["ref"][key]):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    bad = {side: [_post(app, "/kv/fetch", p)[0] for p in
                  ({}, {"keys": "k"}, {"keys": ["k"] * 65}, {"keys": ["k"], "fence_epoch": "x"},
                   {"keys": ["k"], "fence_epoch": 999})]
           for side, (app, _, _) in sides.items()}
    assert bad["port"] == bad["ref"] == [400, 400, 400, 400, 409]


def test_resume_with_last_event_id(served):
    """A keyed stream dropped after its third frame, re-attached with
    ``Last-Event-ID``: the replayed suffix completes the tokens an unbroken
    stream gives."""
    _, sides = served
    got = {}
    for side, (app, _, _) in sides.items():
        full = sse(app, {"prompt": "resume me", "max_tokens": 8})
        key = {"Idempotency-Key": f"k-{side}-{time.monotonic_ns()}"}
        first = sse(app, {"prompt": "resume me", "max_tokens": 8}, key, keep=3)
        last = first[-1][0]
        rest = sse(app, {}, {**key, "Last-Event-ID": str(last)})
        tokens = [d["token"] for _, d in first[1:] + rest[1:] if isinstance(d, dict) and "token" in d]
        want = [d["token"] for _, d in full if isinstance(d, dict) and "token" in d]
        assert tokens == want
        unknown = _post(app, "/generate/stream", {},
                        {"Idempotency-Key": "never-seen", "Last-Event-ID": "1"})[0]
        badseq = _post(app, "/generate/stream", {}, {**key, "Last-Event-ID": "x"})[0]
        got[side] = (_strip_ids(rest), rest[0][1]["resumed"] == last, unknown, badseq)
    assert got["port"] == got["ref"]
    assert got["port"][2:] == (404, 400)


def test_metrics_families(served):
    _, sides = served
    got = {}
    for side, (app, _, _) in sides.items():
        text = fetch(f"http://127.0.0.1:{app.metrics_port}/metrics")[2].decode()
        got[side] = sorted({line.split()[2] for line in text.splitlines()
                            if line.startswith("# TYPE")})
        assert "app_request_ttft_seconds_count" in text and "app_http_response_count" in text
    assert got["port"] == got["ref"]


def test_models_route(served):
    _, sides = served
    got = {side: json.loads(fetch(_url(app, "/v1/models"))[2]) for side, (app, _, _) in
           sides.items()}
    assert got["port"] == got["ref"]


# ------------------------------------------------- shed and expiry on held engines
@pytest.fixture(scope="module")
def held(models):
    """Unstarted dense engines behind started apps: requests queue."""
    out = {}
    for side in ("ref", "port"):
        app, engine = _build(models, side, "dense", start=False, max_queue=3)
        out[side] = (app, engine, start_app(app))
    yield out
    for app, engine, thread in out.values():
        stop_app(app, thread)


def test_shed_429_and_expiry_504(held):
    got = {}
    for side, (app, engine, _) in held.items():
        # a queued request that expires before the engine starts: 504
        result: dict = {}

        def expiring():
            result["r"] = _post(app, "/generate", {"prompt": "late", "max_tokens": 2},
                                {"X-Request-Timeout": "0.2"})

        t = threading.Thread(target=expiring)
        t.start()
        deadline = time.monotonic() + 10
        while engine._sched.pending() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        # with a 10 s service-time estimate and one request queued, a
        # 0.5 s deadline cannot be met: 429 + Retry-After
        engine._shed.observe_request(10.0)
        shed = _post(app, "/generate", {"prompt": "doomed", "max_tokens": 2},
                     {"X-Request-Timeout": "0.5"})
        shed_sse = _post(app, "/generate/stream", {"prompt": "doomed", "max_tokens": 2},
                         {"X-Request-Timeout": "0.5"})
        time.sleep(0.3)
        engine.start()
        t.join(timeout=TIMEOUT)
        late = result["r"]
        got[side] = (shed[0], shed[1].get("Retry-After"), shed[2]["error"]["retry_after_s"] > 0,
                     shed_sse[0], late[0], late[2])
    assert got["port"] == got["ref"]
    assert got["port"][0] == 429 and got["port"][1] and got["port"][4] == 504
