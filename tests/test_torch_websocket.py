"""The port's WebSocket module (``gofr_tpu_torch/websocket.py``) beside the
JAX package's (``gofr_tpu/websocket.py``): the RFC 6455 frame codec byte for
byte on seeded payloads at every length-encoding edge, masked and not, each
side decoding the other's frames; ``accept_key``; the reference's own
WebSocket tests run on both apps (echo, an unregistered route staying HTTP,
the upgrade gated by auth, interleaved PING reassembly), driven by the
port's client (``WSClient``, which needs no WebSocket library); the draining
503; and an outbound service (``add_ws_service``) against the port's own
server."""

import asyncio
import base64
import json
import os
import threading
import time

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.websocket as rws
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu_torch import websocket as tws
from gofr_tpu_torch.app import App as TApp
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app
from gofr_tpu_torch.websocket import WSClient, WSHandshakeError

SIDES = {"ref": (gofr_tpu.App, RMapConfig), "port": (TApp, TMapConfig)}
SIZES = (0, 125, 126, 65535, 65536)
KEY = b"\x9a\x17\x3c\xe0"
TIMEOUT = 30


def _payload(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()


def _reader(data: bytes) -> asyncio.StreamReader:
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    return reader


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("n", SIZES)
def test_frame_bytes_equal_the_reference(monkeypatch, n, mask):
    """The same opcode and payload encode to the same bytes (a masked frame
    under the same 4-byte key), and each package decodes the other's frame
    to the payload."""
    monkeypatch.setattr(os, "urandom", lambda k: KEY[:k])
    payload = _payload(n)
    ours = tws._encode_frame(tws.OP_BINARY, payload, mask=mask)
    theirs = rws._encode_frame(rws.OP_BINARY, payload, mask=mask)
    assert ours == theirs
    assert ours[1] & 0x80 == (0x80 if mask else 0)

    async def decode():
        return (await tws._read_frame(_reader(theirs)), await rws._read_frame(_reader(ours)))

    got_port, got_ref = asyncio.run(decode())
    assert got_port == got_ref == (True, tws.OP_BINARY, payload)


@pytest.mark.parametrize("seed", range(4))
def test_accept_key_equals_the_reference(seed):
    key = base64.b64encode(np.random.default_rng(seed).bytes(16)).decode()
    assert tws.accept_key(key) == rws.accept_key(key)
    # RFC 6455 §1.3's worked example
    assert tws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_frame_codec_roundtrip():
    """The reference's ``test_frame_codec_roundtrip`` on the port's codec."""
    frame = tws._encode_frame(tws.OP_TEXT, b"hello", mask=False)
    assert frame[0] == 0x80 | tws.OP_TEXT
    assert frame[1] == 5
    assert frame[2:] == b"hello"
    big = tws._encode_frame(tws.OP_TEXT, b"x" * 300, mask=False)
    assert big[1] == 126  # extended 16-bit length


@pytest.mark.parametrize("module", [rws, tws], ids=["ref", "port"])
def test_read_message_reassembles_interleaved_ping(module):
    """RFC6455 §5.4: a PING between fragments must not discard the partial
    message (the reference's test, on both packages)."""

    def frame(opcode, payload, fin):
        return bytes([(0x80 if fin else 0) | opcode, len(payload)]) + payload

    stream = (frame(module.OP_TEXT, b"hel", fin=False) + frame(module.OP_PING, b"p", fin=True)
              + frame(module.OP_CONT, b"lo", fin=True))
    pongs = []

    async def scenario():
        async def pong(payload):
            pongs.append(payload)

        return await module.read_message(_reader(stream), pong=pong)

    assert asyncio.run(scenario()) == (module.OP_TEXT, b"hello")
    assert pongs == [b"p"]


def _app(side, **extra):
    cls, config = SIDES[side]
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "HTTP_HOST": "127.0.0.1", "APP_NAME": f"ws-{side}", "LOG_LEVEL": "FATAL",
              "SHUTDOWN_GRACE_PERIOD": "5", **extra}
    return cls(config(values, use_env=False))


@pytest.fixture(scope="module")
def echo_apps():
    """The reference's ``ws_app`` fixture on each package: an echo handler on
    ``/ws/{id}``."""
    out = {}
    for side in SIDES:
        app = _app(side)

        def echo_handler(ctx):
            return {"echo": ctx.bind(dict), "route_id": ctx.path_param("id")}

        def push_handler(ctx):
            # a sync handler (an executor thread) pushing frames of its own
            n = ctx.bind(dict)["n"]
            for k in range(n):
                ctx.write_message_to_socket({"k": k})
            return {"pushed": n}

        app.websocket("/ws/{id}", echo_handler)
        app.websocket("/push", push_handler)
        out[side] = (app, start_app(app))
    yield out
    for app, thread in out.values():
        stop_app(app, thread)


def _talk(port: int, path: str, messages: list, headers=None) -> list:
    async def run():
        async with await WSClient.connect(f"ws://127.0.0.1:{port}{path}", headers=headers,
                                          timeout=TIMEOUT) as ws:
            replies = []
            for m in messages:
                await ws.send(m)
                replies.append(json.loads(await asyncio.wait_for(ws.recv(), TIMEOUT)))
            return replies

    return asyncio.run(run())


def test_websocket_echo_roundtrip(echo_apps):
    """Two messages on one connection (the handler loop keeps running), the
    path parameter bound, the same replies from both packages."""
    replies = {side: _talk(app.http_port, "/ws/42", [json.dumps({"msg": "hello"}),
                                                     json.dumps({"msg": "again"})])
               for side, (app, _) in echo_apps.items()}
    assert replies["port"] == replies["ref"] == [
        {"echo": {"msg": "hello"}, "route_id": "42"}, {"echo": {"msg": "again"}, "route_id": "42"}]


def test_write_message_to_socket_from_a_sync_handler(echo_apps):
    """``ctx.write_message_to_socket`` from a sync handler blocks until each
    frame is sent, so its frames arrive in order before the reply."""

    async def run(port):
        async with await WSClient.connect(f"ws://127.0.0.1:{port}/push",
                                          timeout=TIMEOUT) as ws:
            await ws.send(json.dumps({"n": 3}))
            return [json.loads(await asyncio.wait_for(ws.recv(), TIMEOUT)) for _ in range(4)]

    got = {side: asyncio.run(run(app.http_port)) for side, (app, _) in echo_apps.items()}
    assert got["port"] == got["ref"] == [{"k": 0}, {"k": 1}, {"k": 2}, {"pushed": 3}]


def test_websocket_handler_errors_answer_a_frame(echo_apps):
    """A body that does not bind is answered with the same typed error frame
    on both packages (the request/reply contract holds on errors)."""
    replies = {side: _talk(app.http_port, "/ws/1", ["{not json"])
               for side, (app, _) in echo_apps.items()}
    assert replies["port"] == replies["ref"]
    assert "error" in replies["port"][0]


def test_websocket_unregistered_route_stays_http(echo_apps):
    """A plain HTTP request to a ws route path is a 404 on both packages."""
    for app, _ in echo_apps.values():
        assert fetch(f"http://127.0.0.1:{app.http_port}/ws/42")[0] == 404


@pytest.mark.parametrize("side", list(SIDES))
def test_websocket_upgrade_gated_by_auth(side):
    """WS upgrades pass the same auth middleware as plain routes: without
    credentials the handshake is refused with a 401, with them it upgrades
    and the handler sees who authenticated."""
    app = _app(side)
    app.enable_basic_auth({"admin": "secret"})
    app.websocket("/ws", lambda ctx: {"ok": True, "user": ctx.get_auth_info().get_username()})
    thread = start_app(app)
    url = f"ws://127.0.0.1:{app.http_port}/ws"
    try:
        async def refused():
            with pytest.raises(WSHandshakeError) as info:
                await WSClient.connect(url, timeout=TIMEOUT)
            return info.value.status, json.loads(info.value.body)

        assert asyncio.run(refused()) == (401, {"error": {"message": "Unauthorized"}})
        creds = base64.b64encode(b"admin:secret").decode()
        assert _talk(app.http_port, "/ws", [json.dumps({})],
                     {"Authorization": f"Basic {creds}"}) == [{"ok": True, "user": "admin"}]
    finally:
        stop_app(app, thread)


@pytest.mark.parametrize("side", list(SIDES))
def test_upgrade_while_draining_is_a_503(side):
    """A draining app refuses new connections before the handshake with the
    retriable 503 its HTTP routes answer."""
    app = _app(side)
    app.websocket("/ws", lambda ctx: {"ok": True})
    thread = start_app(app)
    try:
        app.container.draining = True

        async def refused():
            with pytest.raises(WSHandshakeError) as info:
                await WSClient.connect(f"ws://127.0.0.1:{app.http_port}/ws", timeout=TIMEOUT)
            return info.value.status

        assert asyncio.run(refused()) == 503
    finally:
        app.container.draining = False
        stop_app(app, thread)


def test_client_frames_are_masked_and_the_close_is_answered():
    """The port's client masks every frame it sends (RFC 6455 §5.3) and
    completes the closing handshake the server starts."""
    seen, closes = [], []

    async def server(reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        key = [line.split(":", 1)[1].strip() for line in head.decode().split("\r\n")
               if line.lower().startswith("sec-websocket-key")][0]
        writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                      "Connection: Upgrade\r\n"
                      f"Sec-WebSocket-Accept: {tws.accept_key(key)}\r\n\r\n").encode())
        raw = await reader.readexactly(2)
        seen.append(raw[1] & 0x80)
        rest = await reader.readexactly(4 + (raw[1] & 0x7F))
        seen.append(tws._mask(rest[4:], rest[:4]))
        writer.write(tws._encode_frame(tws.OP_TEXT, b"reply"))
        writer.write(tws._encode_frame(tws.OP_CLOSE, b"\x03\xe8"))
        await writer.drain()
        closes.append(await tws._read_frame(reader))
        writer.close()

    async def scenario():
        srv = await asyncio.start_server(server, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        ws = await WSClient.connect(f"ws://127.0.0.1:{port}/", timeout=TIMEOUT)
        await ws.send("hi")
        reply = await asyncio.wait_for(ws.recv(), TIMEOUT)
        await asyncio.wait_for(ws.wait_closed(), TIMEOUT)
        with pytest.raises(ConnectionError):
            await ws.recv()
        with pytest.raises(ConnectionError):
            await ws.send("late")
        await ws.close()
        srv.close()
        await srv.wait_closed()
        return reply, ws.close_code

    assert asyncio.run(scenario()) == ("reply", 1000)
    assert seen == [0x80, b"hi"]
    fin, opcode, payload = closes[0]
    assert (fin, opcode, payload) == (True, tws.OP_CLOSE, b"\x03\xe8")


def test_outbound_service_writes_through_the_port_client():
    """``add_ws_service`` connects at start with the port's client (no
    WebSocket library), and ``ctx.write_message_to_service`` from a sync
    handler (an executor thread) and an async one (the loop) reach the
    other app's socket handler in order."""
    received, got_all = [], threading.Event()
    server = _app("port")

    def sink(ctx):
        received.append(ctx.bind(dict))
        if len(received) == 2:
            got_all.set()

    server.websocket("/sink", sink)
    server_thread = start_app(server)
    client = _app("port")
    client.add_ws_service("sink", f"ws://127.0.0.1:{server.http_port}/sink")

    def send_sync(ctx):
        ctx.write_message_to_service("sink", {"n": 1})
        return "sent"

    async def send_async(ctx):
        ctx.write_message_to_service("sink", {"n": 2})
        return "sent"

    client.post("/sync", send_sync)
    client.post("/async", send_async)
    client_thread = start_app(client)
    try:
        deadline = time.monotonic() + TIMEOUT
        while "sink" not in client.container.ws_manager.services:
            assert time.monotonic() < deadline, "the service never connected"
            time.sleep(0.02)
        base = f"http://127.0.0.1:{client.http_port}"
        assert fetch(base + "/sync", "POST", b"{}", {"Content-Type": "application/json"})[0] == 201
        assert fetch(base + "/async", "POST", b"{}", {"Content-Type": "application/json"})[0] == 201
        assert got_all.wait(TIMEOUT)
        assert received == [{"n": 1}, {"n": 2}]
    finally:
        stop_app(client, client_thread)
        stop_app(server, server_thread)
    assert client.container.ws_manager.services == {}
