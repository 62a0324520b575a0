"""``register_generation_ws`` over real sockets: a JAX ``App`` with a tiny JAX
engine beside a port ``App`` with a tiny port engine (``device="cpu"``), on
the dense and the paged layouts, at ``LlamaConfig.tiny`` (vocab 300, the JAX
package's params carried across), driven by the port's WebSocket client.
The reference's three WebSocket serving cases
(``tests/test_serving.py``: token streaming with the summary frame and the
error frame, a client that drops its socket mid-stream, a graceful close
mid-stream) run on both: the same frames and summaries, the tokens of
``engine.submit``, and on both sides the dropped or closed stream cancels
its request and frees its slot (and, paged, its pages)."""

import asyncio
import json
import time

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
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import get_free_port, start_app, stop_app  # noqa: E402
from gofr_tpu_torch.websocket import WSClient  # noqa: E402

BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
            prefill_chunk_tokens=16)
LAYOUT_KW = {"dense": {}, "paged": dict(kv_layout="paged", kv_page_size=8)}
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


def _build(models, side, layout, **kw):
    """(app, engine) of one side with only the WebSocket surface
    registered (it wires the engine's lifecycle itself)."""
    jcfg, jparams, tcfg, tparams = models
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "HTTP_HOST": "127.0.0.1", "APP_NAME": f"ws-{side}-{layout}", "LOG_LEVEL": "FATAL",
              "SHUTDOWN_GRACE_PERIOD": "5"}
    conf = {**BASE, **LAYOUT_KW[layout], **kw}
    if side == "ref":
        app = gofr_tpu.App(RMapConfig(values, use_env=False))
        engine = JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer())
        r_handlers.register_generation_ws(app, engine)
    else:
        app = TApp(TMapConfig(values, use_env=False))
        engine = ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(),
                               device="cpu")
        t_handlers.register_generation_ws(app, engine)
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


def _ws(app, messages: list, keep: int | None = None, close: bool = False) -> list:
    """Send each message on one connection and read its frames up to the
    summary or an error frame; with ``keep``, leave after that many frames
    of the first message, by a close frame or by dropping the socket."""

    async def run():
        ws = await WSClient.connect(f"ws://127.0.0.1:{app.http_port}/ws/generate",
                                    timeout=TIMEOUT)
        replies = []
        try:
            for message in messages:
                await ws.send(json.dumps(message))
                frames = []
                while keep is None or len(frames) < keep:
                    frame = json.loads(await asyncio.wait_for(ws.recv(), TIMEOUT))
                    frames.append(frame)
                    if frame.get("done") or "error" in frame:
                        break
                replies.append(frames)
                if keep is not None:
                    break
        finally:
            if keep is not None and not close:
                ws.abort()
            else:
                await ws.close()
        return replies

    return asyncio.run(run())


def _wait_clean(engine, timeout=30):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        busy = any(s is not None for s in engine.slots) or engine._sched.stats()["busy_slots"]
        pc = engine.paged_cache
        pages = pc is not None and pc.stats()["free_blocks"] != pc.stats()["total_blocks"]
        if not busy and not pages:
            return True
        time.sleep(0.01)
    return False


PROMPTS = [{"prompt": "ws stream", "max_tokens": 4, "temperature": 0},
           {"prompt": "a prompt longer than every bucket we have", "max_tokens": 7},
           {"prompt": [5, 6, 7, 8], "max_tokens": 3}]


def test_token_streaming_and_error_frame(served):
    """A frame per token then one summary frame, the same on both engines
    and the tokens of ``engine.submit``; a request without a prompt answers
    an error frame naming it, and the connection keeps serving."""
    layout, sides = served
    got = {side: _ws(app, PROMPTS + [{"max_tokens": 2}, PROMPTS[0]])
           for side, (app, _, _) in sides.items()}
    assert got["port"] == got["ref"]
    *streams, err, again = got["port"]
    assert "prompt" in err[0]["error"]["message"]
    assert again == streams[0]
    engine = sides["port"][1]
    for message, frames in zip(PROMPTS, streams):
        summary = frames[-1]
        assert summary == {"done": True, "tokens": len(frames) - 1,
                           "finish_reason": summary["finish_reason"]} and len(frames) > 1
        for f in frames[:-1]:
            assert set(f) == {"token", "text"}
        want = engine.submit(message["prompt"], max_new_tokens=message["max_tokens"],
                             temperature=0.0).result(TIMEOUT)
        assert [f["token"] for f in frames[:-1]] == want.token_ids
        assert summary["finish_reason"] == want.finish_reason


@pytest.mark.parametrize("close", [False, True], ids=["disconnect", "graceful_close"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_leaving_mid_stream_cancels_generation(models, layout, close):
    """A client that reads one token frame of a 50-token generation, then
    drops its socket (the awaited send fails) or sends a close frame (the
    upgrader services the wire while the handler runs): on both engines
    the request is canceled and its slot (and pages) freed long before the
    generation would end."""
    outcomes = {}
    for side in ("ref", "port"):
        app, engine = _build(models, side, layout, max_seq_len=64)
        retired = []
        real = engine._retire

        def recorded(slot, reason, _real=real):
            retired.append(reason)
            return _real(slot, reason)

        engine._retire = recorded
        thread = start_app(app)
        try:
            frames = _ws(app, [{"prompt": "drop me", "max_tokens": 50, "temperature": 0}],
                         keep=1, close=close)[0]
            assert "token" in frames[0]
            outcomes[side] = (_wait_clean(engine), retired)
        finally:
            stop_app(app, thread)
    assert outcomes["port"] == outcomes["ref"] == (True, ["cancel"])
