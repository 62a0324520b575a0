"""The port's gRPC server and client (``gofr_tpu_torch/grpcx``, on the
port's own HTTP/2 wire) held to the JAX package's (``gofr_tpu/grpcx`` on
grpcio), on the CPU at ``LlamaConfig.tiny`` (vocab 300, the JAX package's
params carried across), as ``tests/test_grpc.py`` builds them.

Each case of ``tests/test_grpc.py`` runs over a matrix of server and client:
the port's server driven by a real ``grpc.aio`` client, the JAX package's
grpcio server driven by the port's client, and the port's client against the
port's server, each beside the reference's own pair. They must agree on
Echo, the health answer, Generate's greedy text and usage, GenerateStream's
frames (the tokens equal between the packages, the ``done`` frame with its
``finish_reason``), INVALID_ARGUMENT, the interceptor's histograms, and the
lifecycle mapping (shed → RESOURCE_EXHAUSTED with ``retry-delay-s``, expiry →
DEADLINE_EXCEEDED, 413 → FAILED_PRECONDITION, drain → UNAVAILABLE while
health answers NOT_SERVING). Then what the transport adds: a client's
cancel mid-stream frees the engine's row, a queued request whose deadline
lapses is DEADLINE_EXCEEDED and never prefilled, ``x-tenant-id`` reaches the
engine's tenant, the server span continues the caller's ``traceparent``, an
Embed larger than 64 KiB each way (flow control), a handler panic is INTERNAL
with ``grpc_server_errors_total``, and the cases of ``test_lifecycle.py``,
``test_observability.py`` and ``test_tenancy.py`` that touch gRPC."""

import asyncio
import json
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
grpc = pytest.importorskip("grpc")

import gofr_tpu.grpcx as rgrpcx  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.grpcx import inference as rinference  # noqa: E402
from gofr_tpu.grpcx import server as rserver  # noqa: E402
from gofr_tpu.http import errors as rerrors  # noqa: E402
from gofr_tpu.models import bert as jbert  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.testutil import new_mock_container as rmock  # noqa: E402
from gofr_tpu.tracing.trace import Tracer as RTracer  # noqa: E402

import gofr_tpu_torch.grpcx as tgrpcx  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.grpcx import h2  # noqa: E402
from gofr_tpu_torch.grpcx import inference as tinference  # noqa: E402
from gofr_tpu_torch.grpcx import server as tserver  # noqa: E402
from gofr_tpu_torch.http import errors as terrors  # noqa: E402
from gofr_tpu_torch.models import bert as tbert  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import get_free_port, new_mock_container as tmock  # noqa: E402
from gofr_tpu_torch.tracing.trace import Tracer as TTracer  # noqa: E402

ENGINE_KW = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32))
TIMEOUT = 60

# (server side, client side): the reference's own pair is the baseline
MATRIX = [("ref", "grpcio"), ("port", "grpcio"), ("ref", "port"), ("port", "port")]
IDS = [f"{s}-server-{c}-client" for s, c in MATRIX]
CLIENTS = {"grpcio": rinference.InferenceClient, "port": tinference.InferenceClient}


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


def _engine(models, side, **kw):
    jcfg, jparams, tcfg, tparams = models
    conf = {**ENGINE_KW, **kw}
    if side == "ref":
        return JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer())
    return ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(), device="cpu")


@pytest.fixture(scope="module")
def engines(models):
    out = {side: _engine(models, side) for side in ("ref", "port")}
    for e in out.values():
        e.start()
    yield out
    for e in out.values():
        e.stop()


def _server(side, service, config=None):
    """(server, container, port) of one package, not started."""
    port = get_free_port()
    if side == "ref":
        container, _ = rmock()
        server = rgrpcx.GRPCServer(container, port, RMapConfig(config or {}, use_env=False))
    else:
        container, _ = tmock()
        server = tgrpcx.GRPCServer(container, port, TMapConfig(
            {"HTTP_HOST": "127.0.0.1", **(config or {})}, use_env=False))
    server.register(service)
    return server, container, port


def _service(side, engine=None, embedder=None):
    mod = rinference if side == "ref" else tinference
    return mod.InferenceService(engine, embedder=embedder)


def _code(exc) -> str:
    return exc.code().name


def _drive(coro_fn, side, service, client, config=None):
    """Start ``side``'s server with ``service``, run ``coro_fn(client,
    container)`` against it, stop it; returns (result, container)."""
    server, container, port = _server(side, service, config)

    async def run():
        await server.start()
        c = CLIENTS[client](f"127.0.0.1:{port}")
        try:
            return await asyncio.wait_for(coro_fn(c, container), TIMEOUT)
        finally:
            await c.close()
            await server.shutdown(grace=0.5)

    return asyncio.run(run()), container


def _end_to_end_record(engines, side, client):
    async def scenario(c, container):
        rec = {"echo": await c.echo({"ping": 1}), "health": await c.health()}
        g = await c.generate("abc", max_tokens=4)
        rec["generate"] = (g["text"], g["finish_reason"], g["usage"]["prompt_tokens"],
                           g["usage"]["completion_tokens"])
        rec["stream"] = [f async for f in c.generate_stream("xyz", max_tokens=3)]
        try:
            await c.generate("")
            rec["invalid"] = None
        except Exception as exc:  # noqa: BLE001 - each package's own error type
            rec["invalid"] = _code(exc)
        return rec

    rec, container = _drive(scenario, side, _service(side, engines[side]), client)
    m = container.metrics_manager
    rec["unary_count"] = m.get("app_grpc_server_stats").snapshot(
        {"method": "/gofr.v1.Inference/Generate", "status": "OK"})[1]
    rec["stream_count"] = m.get("app_grpc_stream_stats").snapshot(
        {"method": "/gofr.v1.Inference/GenerateStream", "status": "OK"})[1]
    rec["errors"] = m.get("app_grpc_server_stats").snapshot(
        {"method": "/gofr.v1.Inference/Generate", "status": "ERROR"})[1]
    return rec


def test_grpc_end_to_end_matrix(engines):
    """``test_grpc_end_to_end`` over every server × client pair: the same
    answers, greedy tokens equal between the packages."""
    records = {key: _end_to_end_record(engines, *key) for key in MATRIX}
    want = records[("ref", "grpcio")]
    assert want["echo"] == {"ping": 1} and want["health"] is True
    assert want["invalid"] == "INVALID_ARGUMENT"
    assert want["stream"][-1]["done"] is True and 1 <= len(want["stream"]) - 1 <= 3
    assert want["unary_count"] >= 1 and want["stream_count"] >= 1
    for key, rec in records.items():
        assert rec == want, key


@pytest.mark.parametrize("side", ["ref", "port"])
def test_container_injection(engines, side):
    server, container, _ = _server(side, _service(side, engines[side]))
    svc = _service(side, engines[side])
    assert svc.container is None
    server.register(svc)
    assert svc.container is container


class StubEngine:
    """The engine surface InferenceService calls, raising each package's
    typed lifecycle errors on demand and recording what reached it."""

    def __init__(self, errors_mod):
        self.errors = errors_mod
        self.mode = "ok"
        self.seen: list[dict] = []

    def _raise(self):
        e = self.errors
        if self.mode == "shed":
            raise e.ErrorTooManyRequests(retry_after=2.5)
        if self.mode == "expired":
            raise e.ErrorDeadlineExceeded()
        if self.mode == "too_big":
            raise e.ErrorRequestEntityTooLarge("prompt can never fit")
        if self.mode == "unavailable":
            raise e.ErrorServiceUnavailable("restarting")
        if self.mode == "panic":
            raise RuntimeError("boom")

    async def generate(self, prompt, **kw):
        self.seen.append(kw)
        self._raise()
        return SimpleNamespace(request_id=1, text="ok", finish_reason="stop", prompt_tokens=1,
                               completion_tokens=1, ttft_s=0.0)

    async def stream(self, prompt, on_result=None, **kw):
        self.seen.append(kw)
        self._raise()
        yield 7, "x"
        on_result(SimpleNamespace(finish_reason="stop"))


def _lifecycle_record(side, client):
    stub = StubEngine(rerrors if side == "ref" else terrors)

    async def scenario(c, container):
        rec = {}
        for mode in ("shed", "expired", "too_big", "unavailable", "panic"):
            stub.mode = mode
            try:
                await c.generate("abc")
                rec[mode] = None
            except Exception as exc:  # noqa: BLE001
                trailing = {k: v for k, v in (exc.trailing_metadata() or ())}
                rec[mode] = (_code(exc), trailing.get("retry-delay-s"))
            try:
                frames = [f async for f in c.generate_stream("abc")]
                rec[f"stream_{mode}"] = frames
            except Exception as exc:  # noqa: BLE001
                rec[f"stream_{mode}"] = _code(exc)
        stub.mode = "ok"
        container.draining = True
        try:
            await c.echo({"ping": 1})
            rec["drain"] = None
        except Exception as exc:  # noqa: BLE001
            rec["drain"] = _code(exc)
        rec["drain_health"] = await c.health()
        container.draining = False
        return rec

    rec, container = _drive(scenario, side, _service(side, stub), client)
    text = container.metrics_manager.expose_prometheus()
    rec["errors_total"] = 'grpc_server_errors_total{method="/gofr.v1.Inference/Generate"} 1' in text
    return rec


def test_grpc_lifecycle_error_mapping_matrix():
    """``test_grpc_lifecycle_error_mapping`` (and 413, 503 and a panic) over
    every server × client pair."""
    records = {key: _lifecycle_record(*key) for key in MATRIX}
    want = records[("ref", "grpcio")]
    assert want["shed"] == ("RESOURCE_EXHAUSTED", "2.500")
    assert want["expired"] == ("DEADLINE_EXCEEDED", None)
    assert want["too_big"] == ("FAILED_PRECONDITION", None)
    assert want["unavailable"] == ("UNAVAILABLE", None)
    assert want["panic"] == ("INTERNAL", None)
    assert want["drain"] == "UNAVAILABLE" and want["drain_health"] is False
    assert want["errors_total"] is True
    for key, rec in records.items():
        assert rec == want, key


@pytest.mark.parametrize("side", ["ref", "port"])
def test_grpc_maps_413_to_failed_precondition(side):
    """``tests/test_lifecycle.py:314`` on both packages."""
    mod, errs, codes = ((rinference, rerrors, grpc.StatusCode) if side == "ref"
                        else (tinference, terrors, h2.StatusCode))

    class AbortCalled(Exception):
        pass

    class Ctx:
        code = None

        async def abort(self, code, message):
            self.code = code
            raise AbortCalled()

        def set_trailing_metadata(self, md):
            pass

    ctx = Ctx()
    with pytest.raises(AbortCalled):
        asyncio.run(mod._abort_lifecycle(ctx, errs.ErrorRequestEntityTooLarge("too big")))
    assert ctx.code == codes.FAILED_PRECONDITION
    assert ctx.code.value == grpc.StatusCode.FAILED_PRECONDITION.value


@pytest.mark.parametrize("side", ["ref", "port"])
def test_grpc_traceparent_metadata_roundtrip(side):
    """``tests/test_observability.py:555`` on both packages."""
    srv, inf, tracer_cls = ((rserver, rinference, RTracer) if side == "ref"
                            else (tserver, tinference, TTracer))
    header = f"00-{'c' * 32}-{'d' * 16}-01"
    ctx = SimpleNamespace(invocation_metadata=lambda: (("traceparent", header),))
    assert srv._remote_trace(ctx) == ("c" * 32, "d" * 16)
    assert srv._remote_trace(SimpleNamespace(invocation_metadata=lambda: ())) is None
    tracer = tracer_cls("t")
    assert inf._trace_metadata() is None
    with tracer.start_span("caller") as span:
        md = dict(inf._trace_metadata())
        assert md["traceparent"] == f"00-{span.trace_id}-{span.span_id}-01"


def test_grpc_kwargs_thread_tenancy():
    """``tests/test_tenancy.py:380``'s gRPC half: body and metadata forms
    reach the engine's kwargs the same way on both packages."""

    class GrpcCtx:
        def invocation_metadata(self):
            return (("x-tenant-id", "meta-t"),)

    for body, ctx in (({"prompt": "x", "adapter_id": "a2", "tenant": "body-t"}, None),
                      ({"prompt": "x", "tenant": "body-t"}, GrpcCtx()),
                      ({"prompt": "x", "max_tokens": 3, "temperature": 0.5, "top_k": 4,
                        "top_p": 0.9}, None)):
        assert tinference.InferenceService()._gen_kwargs(body, ctx) == \
            rinference.InferenceService()._gen_kwargs(body, ctx)
    assert tinference.InferenceService()._gen_kwargs(
        {"prompt": "x", "tenant": "body-t"}, GrpcCtx())["tenant"] == "meta-t"


@pytest.mark.parametrize("server_side,client", [("port", "grpcio"), ("ref", "port"),
                                                ("port", "port")])
def test_tenant_metadata_and_traceparent_reach_the_engine(server_side, client):
    """Over the wire: ``x-tenant-id`` outranks the body's tenant, and the
    server span (the engine's ``trace_ctx``) continues the caller's trace."""
    stub = StubEngine(rerrors if server_side == "ref" else terrors)
    header = f"00-{'a' * 32}-{'b' * 16}-01"
    md = (("x-tenant-id", "meta-t"), ("traceparent", header))
    body = json.dumps({"prompt": "hi", "tenant": "body-t"}).encode()

    async def scenario(c, container):
        if client == "grpcio":
            ch = grpc.aio.insecure_channel(c.target)
        else:
            ch = h2.Channel(c.target)
        try:
            call = ch.unary_unary("/gofr.v1.Inference/Generate")
            return json.loads(await call(body, metadata=md, timeout=10))
        finally:
            await ch.close()

    out, _ = _drive(scenario, server_side, _service(server_side, stub), client)
    assert out["text"] == "ok"
    seen = stub.seen[-1]
    assert seen["tenant"] == "meta-t"
    assert seen["trace_ctx"].trace_id == "a" * 32


@pytest.mark.parametrize("server_side,client", [("port", "grpcio"), ("port", "port"),
                                                ("ref", "port")])
def test_cancel_mid_stream_frees_the_row(models, server_side, client):
    """A client that cancels GenerateStream mid-stream (RST_STREAM) cancels
    the handler and, through ``engine.stream``, the row: no busy slot and no
    request left, on both packages' servers."""
    engine = _engine(models, server_side)
    engine.start()
    try:
        async def scenario(c, container):
            body = json.dumps({"prompt": "a long enough prompt", "max_tokens": 48}).encode()
            if client == "grpcio":
                ch = grpc.aio.insecure_channel(c.target)
            else:
                ch = h2.Channel(c.target)
            try:
                call = ch.unary_stream("/gofr.v1.Inference/GenerateStream")(body, timeout=30)
                got = 0
                async for _frame in call:
                    got += 1
                    if got == 2:
                        call.cancel()
                        break
                t0 = time.monotonic()
                while time.monotonic() - t0 < 10 and (
                        any(s is not None for s in engine.slots) or engine._by_id):
                    await asyncio.sleep(0.01)
                return got
            finally:
                await ch.close()

        got, _ = _drive(scenario, server_side, _service(server_side, engine), client)
        assert got == 2
        assert all(s is None for s in engine.slots)
        assert engine._sched.stats()["busy_slots"] == 0
        assert not engine._by_id
    finally:
        engine.stop()


@pytest.mark.parametrize("server_side,client", MATRIX, ids=IDS)
def test_queued_request_past_its_deadline(models, server_side, client):
    """A request queued behind an unstarted engine whose ``grpc-timeout``
    lapses ends DEADLINE_EXCEEDED; once the engine starts, it is dropped
    without a prefill and leaves nothing behind."""
    engine = _engine(models, server_side)
    prefills = []
    for name in ("_prefill_into", "_start_cursor"):
        real = getattr(engine, name, None)
        if real is not None:
            setattr(engine, name, lambda *a, _real=real, **k: (prefills.append(1), _real(*a, **k))[1])

    async def scenario(c, container):
        body = json.dumps({"prompt": "late", "max_tokens": 4}).encode()
        ch = grpc.aio.insecure_channel(c.target) if client == "grpcio" else h2.Channel(c.target)
        try:
            await ch.unary_unary("/gofr.v1.Inference/Generate")(body, timeout=0.4)
            return None
        except Exception as exc:  # noqa: BLE001
            return _code(exc)
        finally:
            await ch.close()

    try:
        code, _ = _drive(scenario, server_side, _service(server_side, engine), client)
        assert code == "DEADLINE_EXCEEDED"
        engine.start()
        t0 = time.monotonic()
        while engine._by_id and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert not engine._by_id
        assert all(s is None for s in engine.slots)
        assert prefills == []
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def bert_models():
    jcfg = jbert.BertConfig.tiny(vocab_size=300)
    jparams = jbert.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tbert.BertConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return (jcfg, jparams, JByteTokenizer()), (tcfg, tparams, ByteTokenizer())


@pytest.mark.parametrize("server_side,client", MATRIX, ids=IDS)
def test_embed_past_64kib_each_way(bert_models, server_side, client):
    """Embed of many texts: the request and the answer each exceed the
    65,535-byte default windows, so both directions ride WINDOW_UPDATEs;
    the embeddings agree between the packages within 1e-4."""
    texts = [f"text {i} " + "x" * 700 for i in range(120)]
    assert len(json.dumps({"input": texts})) > 65_536
    embedder = bert_models[0] if server_side == "ref" else bert_models[1]

    async def scenario(c, container):
        return await c.embed(texts)

    out, _ = _drive(scenario, server_side, _service(server_side, embedder=embedder), client)
    assert len(json.dumps(out)) > 65_536
    assert len(out["embeddings"]) == len(texts)
    _EMBEDS.setdefault("want", out["embeddings"])
    import numpy as np

    np.testing.assert_allclose(np.asarray(out["embeddings"]), np.asarray(_EMBEDS["want"]),
                               atol=1e-4)


_EMBEDS: dict = {}


@pytest.mark.parametrize("client", ["grpcio", "port"])
def test_reflection_off_by_default_and_unknown_method(client):
    """Without GRPC_ENABLE_REFLECTION the reflection service is absent
    (UNIMPLEMENTED, as grpcio answers an unknown method), and an unknown
    method of a known service is UNIMPLEMENTED too."""
    async def scenario(c, container):
        ch = grpc.aio.insecure_channel(c.target) if client == "grpcio" else h2.Channel(c.target)
        out = []
        try:
            for path in ("/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
                         "/gofr.v1.Inference/NoSuch"):
                try:
                    await ch.unary_unary(path)(b"", timeout=5)
                    out.append(None)
                except Exception as exc:  # noqa: BLE001
                    out.append(_code(exc))
            return out
        finally:
            await ch.close()

    got = {side: _drive(scenario, side, _service(side), client)[0] for side in ("ref", "port")}
    assert got["port"] == got["ref"] == ["UNIMPLEMENTED", "UNIMPLEMENTED"]


def test_register_after_start_raises():
    server, _container, _port = _server("port", _service("port"))

    async def run():
        await server.start()
        try:
            with pytest.raises(RuntimeError):
                server.register(_service("port"))
        finally:
            await server.shutdown(grace=0.1)

    asyncio.run(run())


def test_app_serves_grpc_on_its_loop():
    """``App.register_grpc_service`` starts the server with the app's, on
    ``GRPC_PORT``, names it in the boot line, and stops it at shutdown."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.testutil import start_app, stop_app

    grpc_port = get_free_port()
    app = App(TMapConfig({"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
                          "GRPC_PORT": str(grpc_port), "HTTP_HOST": "127.0.0.1",
                          "LOG_LEVEL": "FATAL"}, use_env=False))
    app.register_grpc_service(_service("port"))
    assert app.grpc_server.port == grpc_port
    thread = start_app(app)
    try:
        async def call():
            c = tinference.InferenceClient(f"127.0.0.1:{grpc_port}")
            try:
                return await c.echo({"ping": 2}), await c.health()
            finally:
                await c.close()

        assert asyncio.run(call()) == ({"ping": 2}, True)
    finally:
        stop_app(app, thread)
    assert app.grpc_server._server is None
