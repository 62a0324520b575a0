"""Typed gRPC codegen of the port (``gofr_tpu_torch/grpcx/codegen.py``) held
to the JAX package's (``tests/test_grpc_codegen.py``), on the CPU.

The same ``chat.proto`` (all four RPC kinds) is compiled once with the system
``protoc`` and generated by each package's codegen; the generated modules
have the same surface (servicer base, ``METHODS``, message aliases, typed
client). One servicer body, subclassed from each package's base, serves on
each package's server and is called by each package's typed client: the
port's server from the reference's grpc.aio client, the reference's grpcio
server from the port's client, and port against port. Every pair returns the
same unary, server-streaming, client-streaming and bidi answers; a wrong
response type is INTERNAL; reflection lists and describes the service, with
file bytes equal to the set's, NOT_FOUND for an unknown symbol and
UNIMPLEMENTED for a request kind it does not serve, the same on both
servers. The port's generator also takes a ``.binpb`` with no protoc, and
the CLI's ``grpc-generate`` writes the same module."""

import asyncio
import importlib.util
import shutil
import subprocess
import sys

import pytest

grpc = pytest.importorskip("grpc")

from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.grpcx import GRPCServer as RGRPCServer  # noqa: E402
from gofr_tpu.grpcx import codegen as rcodegen  # noqa: E402
from gofr_tpu.testutil import new_mock_container as rmock  # noqa: E402

from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.grpcx import GRPCServer as TGRPCServer  # noqa: E402
from gofr_tpu_torch.grpcx import codegen as tcodegen  # noqa: E402
from gofr_tpu_torch.grpcx import h2, protowire  # noqa: E402
from gofr_tpu_torch.testutil import get_free_port, new_mock_container as tmock  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("protoc") is None,
    reason="needs the system protoc binary to compile the test's .proto",
)

CHAT_PROTO = """
syntax = "proto3";
package chat.v1;

service ChatService {
  rpc Say(ChatRequest) returns (ChatResponse);
  rpc Watch(ChatRequest) returns (stream ChatResponse);
  rpc Upload(stream ChatRequest) returns (ChatResponse);
  rpc Converse(stream ChatRequest) returns (stream ChatResponse);
}

message ChatRequest {
  string text = 1;
  int32 count = 2;
}

message ChatResponse {
  string reply = 1;
  int32 index = 2;
}
"""
TIMEOUT = 30


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """{side: generated module}, from one protoc compile."""
    tmp = tmp_path_factory.mktemp("codegen")
    proto = tmp / "chat.proto"
    proto.write_text(CHAT_PROTO)
    fds = tcodegen.load_input(str(proto))
    assert fds == rcodegen.load_input(str(proto))
    (tmp / "chat.binpb").write_bytes(fds)
    out = {}
    for side, gen in (("ref", rcodegen), ("port", tcodegen)):
        modules = gen.generate(fds)
        assert list(modules) == ["chat_gofr.py"]
        dest = tmp / side / "chat_gofr.py"
        dest.parent.mkdir()
        dest.write_text(modules["chat_gofr.py"])
        out[side] = _load(dest, f"chat_gofr_{side}")
    out["dir"] = tmp
    out["fds"] = fds
    yield out
    for side in ("ref", "port"):
        sys.modules.pop(f"chat_gofr_{side}", None)


def _servicer(g):
    class Chat(g.ChatServiceGofrServicer):
        async def Say(self, ctx, request):
            # Context-first signature: the proto request binds like any
            # other transport's body (request_gofr.go:15-53)
            bound = ctx.bind(dict)
            assert bound.get("text", "") == request.text
            return g.ChatResponse(reply=f"hi {request.text}", index=request.count)

        async def Watch(self, ctx, request, stream):
            for i in range(request.count):
                stream.send(g.ChatResponse(reply=request.text, index=i))

        async def Upload(self, ctx, stream):
            texts = [m.text async for m in stream]
            return g.ChatResponse(reply=",".join(texts), index=len(texts))

        async def Converse(self, ctx, stream):
            while True:
                msg = await stream.recv()
                if msg is None:
                    return
                stream.send(g.ChatResponse(reply=msg.text.upper(), index=stream.received))

    return Chat


def _server(side, servicer, reflection=True):
    port = get_free_port()
    conf = {"GRPC_ENABLE_REFLECTION": "true"} if reflection else {}
    if side == "ref":
        container, _ = rmock()
        return RGRPCServer(container, port, RMapConfig(conf, use_env=False)), container, port
    container, _ = tmock()
    return (TGRPCServer(container, port, TMapConfig({"HTTP_HOST": "127.0.0.1", **conf},
                                                    use_env=False)), container, port)


MATRIX = [("ref", "ref"), ("port", "ref"), ("ref", "port"), ("port", "port")]
IDS = [f"{s}-server-{c}-client" for s, c in MATRIX]


def test_generated_module_shape(generated):
    for side in ("ref", "port"):
        g = generated[side]
        assert g.ChatServiceGofrServicer.SERVICE_NAME == "chat.v1.ChatService"
        assert g.ChatServiceGofrServicer.METHODS == generated["ref"].ChatServiceGofrServicer.METHODS
        kinds = {k: v[0] for k, v in g.ChatServiceGofrServicer.METHODS.items()}
        assert kinds == {"Say": "unary_unary", "Watch": "unary_stream",
                         "Upload": "stream_unary", "Converse": "stream_stream"}
        msg = g.ChatRequest(text="x", count=3)
        assert g.ChatRequest.FromString(msg.SerializeToString()).count == 3
        assert set(g.MESSAGES) == set(generated["ref"].MESSAGES)
    port_msg = generated["port"].ChatRequest(text="héllo", count=-7)
    ref_msg = generated["ref"].ChatRequest(text="héllo", count=-7)
    assert port_msg.SerializeToString() == ref_msg.SerializeToString()
    src = (generated["dir"] / "port" / "chat_gofr.py").read_text()
    assert "import grpc" not in src and "google.protobuf" not in src


async def _typed_calls(g) -> dict:
    client = g.ChatServiceGofrClient(_TARGET[0])
    try:
        out = {}
        resp = await client.Say(g.ChatRequest(text="ada", count=7))
        out["say"] = (resp.reply, resp.index)
        frames = [f async for f in client.Watch(g.ChatRequest(text="t", count=3))]
        out["watch"] = [(f.reply, f.index) for f in frames]
        out["watch_typed"] = all(isinstance(f, g.ChatResponse) for f in frames)

        async def uploads():
            for t in ("a", "b", "c"):
                yield g.ChatRequest(text=t)

        resp = await client.Upload(uploads())
        out["upload"] = (resp.reply, resp.index)
        out["converse"] = [(r.reply, r.index) async for r in client.Converse(uploads())]
        return out
    finally:
        await client.close()


_TARGET: list = [None]


def _run_on(side, servicer, coro_fn, reflection=True):
    server, container, port = _server(side, servicer, reflection)
    server.register(servicer)

    async def run():
        await server.start()
        _TARGET[0] = f"127.0.0.1:{port}"
        try:
            return await asyncio.wait_for(coro_fn(), TIMEOUT)
        finally:
            await server.shutdown(grace=0.2)

    return asyncio.run(run()), container


@pytest.mark.parametrize("server_side,client_side", MATRIX, ids=IDS)
def test_typed_service_end_to_end(generated, server_side, client_side):
    servicer = _servicer(generated[server_side])()
    out, container = _run_on(server_side, servicer, lambda: _typed_calls(generated[client_side]))
    assert out == {"say": ("hi ada", 7), "watch": [("t", 0), ("t", 1), ("t", 2)],
                   "watch_typed": True, "upload": ("a,b,c", 3),
                   "converse": [("A", 1), ("B", 2), ("C", 3)]}
    text = container.metrics_manager.expose_prometheus()
    assert 'app_grpc_message_total{direction="send",method="/chat.v1.ChatService/Watch"} 3' in text \
        or 'app_grpc_message_total{method="/chat.v1.ChatService/Watch",direction="send"} 3' in text


def _reflection_calls(client_side):
    from gofr_tpu.grpcx.reflection import _read_binpb
    from gofr_tpu.grpcx.runtime import load_messages

    msgs = load_messages(_read_binpb("reflection.binpb"))
    Req = msgs["grpc.reflection.v1alpha.ServerReflectionRequest"]
    Resp = msgs["grpc.reflection.v1alpha.ServerReflectionResponse"]

    async def requests():
        yield Req(list_services="*")
        yield Req(file_containing_symbol="chat.v1.ChatService")
        yield Req(file_by_filename="chat.proto")
        yield Req(file_containing_symbol="no.such.Symbol")
        yield Req(file_containing_symbol="chat.v1.ChatService.Say")
        yield Req(all_extension_numbers_of_type="chat.v1.ChatRequest")
        yield Req(file_by_filename="health.proto")

    async def go():
        ch = (grpc.aio.insecure_channel(_TARGET[0]) if client_side == "ref"
              else h2.Channel(_TARGET[0]))
        try:
            call = ch.stream_stream(
                "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=Resp.FromString,
            )
            return [r async for r in call(requests())]
        finally:
            await ch.close()

    return go


@pytest.mark.parametrize("server_side,client_side", MATRIX, ids=IDS)
def test_reflection_lists_and_describes(generated, server_side, client_side):
    servicer = _servicer(generated[server_side])()
    responses, _ = _run_on(server_side, servicer, _reflection_calls(client_side))
    assert len(responses) == 7
    names = {s.name for s in responses[0].list_services_response.service}
    assert {"chat.v1.ChatService", "grpc.health.v1.Health",
            "grpc.reflection.v1alpha.ServerReflection"} <= names
    want = [f.raw for f in protowire.parse_descriptor_set(generated["fds"])]
    assert list(responses[1].file_descriptor_response.file_descriptor_proto) == want
    assert list(responses[2].file_descriptor_response.file_descriptor_proto) == want
    assert responses[3].error_response.error_code == grpc.StatusCode.NOT_FOUND.value[0]
    assert list(responses[4].file_descriptor_response.file_descriptor_proto) == want
    assert responses[5].error_response.error_code == grpc.StatusCode.UNIMPLEMENTED.value[0]
    assert responses[6].file_descriptor_response.file_descriptor_proto
    for r in responses:
        assert r.original_request.ByteSize() > 0
    _REFLECTION[(server_side, client_side)] = [r.SerializeToString() for r in responses]
    if ("ref", "ref") in _REFLECTION:
        assert _REFLECTION[(server_side, client_side)] == _REFLECTION[("ref", "ref")]


_REFLECTION: dict = {}


@pytest.mark.parametrize("server_side,client_side", MATRIX, ids=IDS)
def test_response_type_enforced(generated, server_side, client_side):
    """Returning the wrong message type is a server-side INTERNAL, not a
    silent mis-serialization."""
    g = generated[server_side]

    class Bad(g.ChatServiceGofrServicer):
        async def Say(self, ctx, request):
            return g.ChatRequest(text="wrong type")

    async def call():
        gc = generated[client_side]
        client = gc.ChatServiceGofrClient(_TARGET[0])
        try:
            await client.Say(gc.ChatRequest(text="x"))
            return None
        except Exception as exc:  # noqa: BLE001 - each package's error type
            return exc.code().name
        finally:
            await client.close()

    code, _ = _run_on(server_side, Bad(), call, reflection=False)
    assert code == "INTERNAL"


def test_codegen_from_binpb_without_protoc(generated, tmp_path, monkeypatch):
    """A descriptor set needs no protoc: the port's generator writes the same
    module from the ``.binpb`` with ``protoc`` off the path, and so does the
    CLI's ``grpc-generate``."""
    monkeypatch.setenv("PATH", str(tmp_path))  # no protoc reachable
    fds = tcodegen.load_input(str(generated["dir"] / "chat.binpb"))
    want = (generated["dir"] / "port" / "chat_gofr.py").read_text()
    assert tcodegen.generate(fds)["chat_gofr.py"] == want
    with pytest.raises(RuntimeError, match="protoc"):
        tcodegen.load_input(str(generated["dir"] / "chat.proto"))
    with pytest.raises(protowire.DecodeError):
        tcodegen.generate(b"\x0a\xff")
    monkeypatch.undo()
    out = tmp_path / "gen"
    r = subprocess.run([sys.executable, "-m", "gofr_tpu_torch", "grpc-generate",
                        f"--proto={generated['dir'] / 'chat.binpb'}", f"--out={out}"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(generated["dir"].parent.parent), env=_env())
    assert r.returncode == 0, r.stderr
    assert (out / "chat_gofr.py").read_text() == want
    r = subprocess.run([sys.executable, "-m", "gofr_tpu_torch", "bench"], capture_output=True,
                       text=True, timeout=120, env=_env())
    assert r.returncode != 0 and "not written yet" in r.stdout + r.stderr


def _env():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {**os.environ, "PYTHONPATH": root}
