"""WebSockets: server upgrade + per-message handler loop, connection
manager, outbound WS services with reconnection (a copy of
``gofr_tpu/websocket.py``).

Reference parity: pkg/gofr/websocket.go + pkg/gofr/websocket/ —
``app.websocket(route, handler)`` runs the handler per received message
(websocket.go:30-49,100-117), connections are tracked in a manager keyed by
the Sec-WebSocket-Key (middleware/web_socket.go:14-37), writes are
serialized per connection (websocket/websocket.go:21-26), and
``add_ws_service`` maintains an outbound connection with a reconnection
loop (websocket.go:52-98).

Both sides implement RFC6455 framing directly on asyncio streams: the
server on the streams owned by the HTTP server, the outbound client
(:class:`WSClient`) on ``asyncio.open_connection`` with masked client
frames, so no WebSocket library is needed.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import struct
from typing import Any

WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# opcodes
OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_MAGIC).encode()).digest()
    return base64.b64encode(digest).decode()


def _mask(payload: bytes, key: bytes) -> bytes:
    """XOR ``payload`` with the repeated 4-byte ``key`` (RFC6455 §5.3), one
    big-integer XOR instead of a Python loop over the bytes."""
    n = len(payload)
    if not n:
        return b""
    stream = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(payload, "big") ^ int.from_bytes(stream, "big")).to_bytes(n, "big")


def _encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    head = bytes([0x80 | opcode])
    length = len(payload)
    mask_bit = 0x80 if mask else 0
    if length < 126:
        head += bytes([mask_bit | length])
    elif length < (1 << 16):
        head += bytes([mask_bit | 126]) + struct.pack(">H", length)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", length)
    if mask:
        key = os.urandom(4)
        return head + key + _mask(payload, key)
    return head + payload


async def _read_frame(reader: asyncio.StreamReader) -> tuple[bool, int, bytes]:
    header = await reader.readexactly(2)
    fin = bool(header[0] & 0x80)
    opcode = header[0] & 0x0F
    masked = header[1] & 0x80
    length = header[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", await reader.readexactly(2))[0]
    elif length == 127:
        length = struct.unpack(">Q", await reader.readexactly(8))[0]
    if opcode >= 0x8 and (length > 125 or not fin):
        # RFC6455 §5.5: control frames carry ≤125 bytes and must not fragment
        raise ConnectionError("websocket control frame too large or fragmented")
    if length > (64 << 20):
        raise ConnectionError("websocket frame too large")
    key = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(length) if length else b""
    if key:
        payload = _mask(payload, key)
    return fin, opcode, payload


MAX_MESSAGE_BYTES = 64 << 20  # total across a fragment chain, same as per-frame


async def read_message(
    reader: asyncio.StreamReader,
    pong: Any = None,  # async callable(payload) answering PINGs in-place
) -> tuple[int, bytes]:
    """Read one complete message, reassembling FIN=0 fragment chains
    (continuation frames), capped at MAX_MESSAGE_BYTES total (the per-frame
    cap alone is bypassable by fragmenting). Control frames may legally
    interleave within a fragmented message (RFC6455 §5.4): CLOSE is returned
    immediately; a PING is answered via ``pong`` when given — without a
    callback a pre-fragment PING is returned to the caller and a mid-fragment
    one is queued and returned as its own message after reassembly, so the
    caller can still answer it."""
    pending = getattr(reader, "_gofr_pending_pings", None)
    while pending:
        payload = pending.pop(0)
        if pong is not None:
            await pong(payload)  # caller can answer now: do it in-place
        else:
            return OP_PING, payload
    parts: list[bytes] = []
    total = 0
    first_opcode: int | None = None
    pending_pings: list[bytes] = []
    while True:
        fin, opcode, payload = await _read_frame(reader)
        if opcode == OP_CLOSE:
            return opcode, payload
        if opcode in (OP_PING, OP_PONG):
            if opcode == OP_PING and pong is not None:
                await pong(payload)
                continue
            if first_opcode is None:
                return opcode, payload
            if opcode == OP_PING:
                # RFC6455 only requires answering the most recent unanswered
                # PING — keep a tiny bounded queue, not one entry per frame
                pending_pings = pending_pings[-7:] + [payload]
            continue  # mid-fragment PONG: drop it
        total += len(payload)
        if total > MAX_MESSAGE_BYTES:
            raise ConnectionError("websocket message too large")
        if first_opcode is None:
            first_opcode = opcode
        parts.append(payload)
        if fin:
            if pending_pings:
                reader._gofr_pending_pings = pending_pings  # type: ignore[attr-defined]
            return first_opcode, b"".join(parts)


def _dispatch_send(loop: asyncio.AbstractEventLoop, coro: Any, bg_sends: set) -> None:
    """Run a send coroutine from either the event loop (schedule, keep a
    strong ref until done) or an executor thread (block until sent) — sync
    handlers run in the executor (handler.py), so both call sites exist."""
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        task = loop.create_task(coro)
        bg_sends.add(task)
        task.add_done_callback(bg_sends.discard)
    else:
        asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=30)


class Connection:
    """Thread/task-safe server-side connection (websocket/websocket.go:21-26:
    per-connection write mutex)."""

    def __init__(self, key: str, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.key = key
        self._reader = reader
        self._writer = writer
        self._write_lock = asyncio.Lock()
        self.closed = False
        self._bg_sends: set = set()  # strong refs to fire-and-forget sends

    async def send_async(self, data: Any) -> None:
        if self.closed:
            # streaming handlers rely on this: a peer CLOSE (or transport
            # death) observed by the upgrader marks the connection closed,
            # and the handler's next awaited send unwinds it
            raise ConnectionError("websocket closed")
        if isinstance(data, (dict, list)):
            payload, op = json.dumps(data).encode(), OP_TEXT
        elif isinstance(data, str):
            payload, op = data.encode(), OP_TEXT
        else:
            payload, op = bytes(data), OP_BINARY
        async with self._write_lock:
            self._writer.write(_encode_frame(op, payload))
            await self._writer.drain()

    def send(self, data: Any) -> None:
        """Sync facade. From an executor thread it blocks until sent; called
        on the event loop itself it schedules the send instead of blocking
        (blocking there would deadlock the loop against its own coroutine)."""
        loop = getattr(self, "_loop", None)
        if loop is None:
            raise RuntimeError("connection not bound to a loop")
        _dispatch_send(loop, self.send_async(data), self._bg_sends)

    async def close(self, code: int = 1000) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            async with self._write_lock:
                self._writer.write(_encode_frame(OP_CLOSE, struct.pack(">H", code)))
                await self._writer.drain()
            self._writer.close()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


class WSHandshakeError(ConnectionError):
    """The server answered the upgrade with something other than 101: its
    status and body (a 401 from the auth chain, a 503 while draining)."""

    def __init__(self, status: int, body: bytes = b"") -> None:
        super().__init__(f"websocket upgrade refused: HTTP {status}")
        self.status = status
        self.body = body


class WSClient:
    """An outbound WebSocket connection (RFC6455 client side) over
    ``asyncio.open_connection``: the opening handshake with a checked
    ``Sec-WebSocket-Accept``, masked client frames, and a reader task that
    answers PINGs, queues data messages for :meth:`recv` and completes the
    closing handshake. ``ws://`` and ``wss://`` URLs."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._reader = reader
        self._writer = writer
        self._write_lock = asyncio.Lock()
        self._messages: asyncio.Queue = asyncio.Queue()
        self.closed = False  # a CLOSE was sent or received, or the transport died
        self.close_code: int | None = None
        self._reader_task = asyncio.ensure_future(self._read_loop())

    @classmethod
    async def connect(cls, url: str, headers: dict[str, str] | None = None,
                      timeout: float = 10.0) -> "WSClient":
        import ssl
        import urllib.parse

        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme not in ("ws", "wss"):
            raise ValueError(f"not a websocket URL: {url!r}")
        secure = parsed.scheme == "wss"
        host = parsed.hostname or "localhost"
        port = parsed.port or (443 if secure else 80)
        target = (parsed.path or "/") + (f"?{parsed.query}" if parsed.query else "")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port, ssl=ssl.create_default_context() if secure else None),
            timeout,
        )
        try:
            key = base64.b64encode(os.urandom(16)).decode()
            lines = [f"GET {target} HTTP/1.1", f"Host: {host}:{port}", "Upgrade: websocket",
                     "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
                     "Sec-WebSocket-Version: 13"]
            lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
            await writer.drain()
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
            status_line, *header_lines = head.decode("latin-1").split("\r\n")
            parts = status_line.split(" ", 2)
            status = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
            got = {}
            for line in header_lines:
                name, sep, value = line.partition(":")
                if sep:
                    got[name.strip().lower()] = value.strip()
            if status != 101:
                length = int(got.get("content-length", "0") or 0)
                body = await asyncio.wait_for(reader.readexactly(length), timeout) if length else b""
                raise WSHandshakeError(status, body)
            if got.get("sec-websocket-accept") != accept_key(key):
                raise ConnectionError("websocket upgrade: bad Sec-WebSocket-Accept")
        except BaseException:
            writer.close()
            raise
        return cls(reader, writer)

    async def __aenter__(self) -> "WSClient":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    async def _write(self, opcode: int, payload: bytes) -> None:
        async with self._write_lock:
            self._writer.write(_encode_frame(opcode, payload, mask=True))
            await self._writer.drain()

    async def _read_loop(self) -> None:
        async def pong(payload: bytes) -> None:
            await self._write(OP_PONG, payload)

        try:
            while True:
                opcode, payload = await read_message(self._reader, pong=pong)
                if opcode == OP_CLOSE:
                    self.close_code = struct.unpack(">H", payload[:2])[0] if len(payload) >= 2 else 1005
                    if not self.closed:
                        self.closed = True
                        try:  # echo the CLOSE: the closing handshake (RFC6455 §5.5.1)
                            await self._write(OP_CLOSE, payload[:2])
                        except (ConnectionError, OSError):
                            pass
                    return
                if opcode in (OP_TEXT, OP_BINARY):
                    self._messages.put_nowait((opcode, payload))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return
        finally:
            self.closed = True
            self._messages.put_nowait(None)  # wakes every recv() after the last message

    async def send(self, data: Any) -> None:
        """A TEXT frame for ``str`` (and JSON for ``dict``/``list``), a BINARY
        frame for bytes. Raises ``ConnectionError`` once closed."""
        if self.closed:
            raise ConnectionError("websocket closed")
        if isinstance(data, (dict, list)):
            await self._write(OP_TEXT, json.dumps(data).encode())
        elif isinstance(data, str):
            await self._write(OP_TEXT, data.encode())
        else:
            await self._write(OP_BINARY, bytes(data))

    async def recv(self) -> str | bytes:
        """The next data message (``str`` for TEXT, ``bytes`` for BINARY);
        ``ConnectionError`` once the connection has closed and every
        message received before the close was read."""
        item = await self._messages.get()
        if item is None:
            self._messages.put_nowait(None)
            raise ConnectionError("websocket closed")
        opcode, payload = item
        return payload.decode() if opcode == OP_TEXT else payload

    async def wait_closed(self) -> None:
        await asyncio.shield(self._reader_task)

    async def close(self, code: int = 1000, timeout: float = 5.0) -> None:
        """The closing handshake: send CLOSE, wait for the peer's, then
        close the transport."""
        if not self.closed:
            self.closed = True
            try:
                await self._write(OP_CLOSE, struct.pack(">H", code))
                await asyncio.wait_for(asyncio.shield(self._reader_task), timeout)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass
        self._reader_task.cancel()
        self._writer.close()

    def abort(self) -> None:
        """Drop the transport with no closing handshake (a client that
        vanishes)."""
        self.closed = True
        self._reader_task.cancel()
        self._writer.transport.abort()


class WSManager:
    """Connection hub (websocket/websocket.go:114-198) + outbound services."""

    def __init__(self, logger: Any = None) -> None:
        self.logger = logger
        self.connections: dict[str, Connection] = {}
        self.services: dict[str, Any] = {}  # name -> client connection
        self._service_urls: dict[str, tuple[str, bool]] = {}  # name -> (url, reconnect)
        self._tasks: list[asyncio.Task] = []
        self._bg_sends: set = set()  # strong refs to fire-and-forget sends
        self._loop: asyncio.AbstractEventLoop | None = None

    def add_connection(self, key: str, conn: Connection) -> None:
        self.connections[key] = conn

    def remove_connection(self, key: str) -> None:
        self.connections.pop(key, None)

    def get_connection(self, key: str) -> Connection | None:
        return self.connections.get(key)

    # -- outbound services (websocket.go:52-98) --------------------------------
    def add_service(self, name: str, url: str, reconnect: bool = True) -> None:
        """Record an outbound service; connected at app start
        (connect_services) with an optional reconnection loop."""
        self._service_urls[name] = (url, reconnect)

    async def connect_services(self) -> None:
        self._loop = asyncio.get_running_loop()
        for name, (url, reconnect) in self._service_urls.items():
            task = asyncio.create_task(
                self._service_loop(name, url, reconnect), name=f"ws-svc-{name}"
            )
            self._tasks.append(task)  # strong ref: loop holds only weak refs

    async def close(self) -> None:
        for task in self._tasks:
            task.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    async def _service_loop(self, name: str, url: str, reconnect: bool) -> None:
        while True:
            try:
                ws = await WSClient.connect(url)
                try:
                    self.services[name] = ws
                    if self.logger:
                        self.logger.info(f"connected to websocket service {name} at {url}")
                    await ws.wait_closed()
                finally:
                    await ws.close()
            except asyncio.CancelledError:
                self.services.pop(name, None)
                raise
            except Exception as exc:
                if self.logger:
                    self.logger.debug(f"ws service {name} connection error: {exc}")
            self.services.pop(name, None)
            if not reconnect:
                return
            await asyncio.sleep(2.0)

    def write_to_service(self, name: str, data: Any) -> None:
        """Safe from both the event loop and executor threads (sync handlers
        run in the executor, handler.py)."""
        ws = self.services.get(name)
        if ws is None:
            raise RuntimeError(f"websocket service {name} not connected")
        if self._loop is None:
            raise RuntimeError("websocket manager not started")
        payload = json.dumps(data) if isinstance(data, (dict, list)) else data
        _dispatch_send(self._loop, ws.send(payload), self._bg_sends)


class _WSRequest:
    """Adapts one received WS message to the Request contract so the same
    Handler signature serves sockets (websocket.go:100-117)."""

    def __init__(self, base_request: Any, message: bytes) -> None:
        self._base = base_request
        self.message = message
        # auth context set by the upgrade gate's middleware carries over to
        # every message handled on this connection (ctx.get_auth_info()).
        self.auth = getattr(base_request, "auth", None)
        self.path = getattr(base_request, "path", "/ws")

    def param(self, key: str) -> str:
        return self._base.param(key)

    def params(self, key: str) -> list[str]:
        return self._base.params(key)

    def path_param(self, key: str) -> str:
        return self._base.path_param(key)

    def header(self, key: str) -> str:
        return self._base.header(key)

    def host_name(self) -> str:
        return self._base.host_name()

    def bind(self, target: Any) -> Any:
        """Reuses the HTTP request's binder so WS payloads behave exactly
        like JSON bodies (same coercion, same BindError on malformed
        input)."""
        if target is bytes:
            return self.message
        if target is str:
            return self.message.decode("utf-8", "replace")
        from gofr_tpu_torch.http.request import Request

        return Request(
            "GET", "/ws", {}, {"Content-Type": "application/json"}, self.message
        ).bind(target)


class WSUpgrader:
    """Plugs into HTTPServer.ws_upgrader: performs the RFC6455 handshake for
    registered ws routes, then runs the per-message handler loop."""

    def __init__(
        self,
        registry: dict[str, Any],
        container: Any,
        middlewares: list[Any] | None = None,
    ) -> None:
        from gofr_tpu_torch.http.responder import WireResponse
        from gofr_tpu_torch.http.router import Router
        from gofr_tpu_torch.http.middleware.core import chain

        self.container = container
        self.router = Router()
        for pattern, handler in registry.items():
            self.router.add("GET", pattern, handler)

        # Auth (and any user) middleware must gate the upgrade exactly as it
        # gates plain routes (the reference runs WS upgrades inside the
        # middleware chain, middleware/web_socket.go:14-37). The gate runs the
        # chain over the upgrade request with a 101-sentinel terminal handler;
        # any middleware rejection (401/403/...) is written back pre-handshake.
        async def _accept(_req: Any) -> WireResponse:
            return WireResponse(status=101)

        self._gate = chain(_accept, middlewares) if middlewares else None

    async def __call__(self, request: Any, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> bool:
        match = self.router.lookup("GET", request.path)
        if match is None:
            return False
        if getattr(self.container, "draining", False):
            # draining: refuse the upgrade with a retriable 503 BEFORE the
            # handshake — established connections keep streaming until the
            # engine drain deadline, but no new one may start
            from gofr_tpu_torch.http.responder import draining_response
            from gofr_tpu_torch.http.server import _serialize_head

            resp = draining_response()
            writer.write(_serialize_head(resp, chunked=False, keep_alive=False) + resp.body)
            await writer.drain()
            return True
        handler, params = match
        request.path_params = params
        client_key = request.header("sec-websocket-key")
        if not client_key:
            return False

        if self._gate is not None:
            from gofr_tpu_torch.http.responder import WireResponse
            from gofr_tpu_torch.http.server import _serialize_head

            try:
                verdict = await self._gate(request)
            except Exception as exc:  # same isolation the HTTP chain gives
                if self.container.logger:
                    self.container.logger.error(f"ws upgrade middleware error: {exc}")
                verdict = WireResponse(
                    status=500,
                    body=b'{"error":{"message":"internal error"}}',
                    headers={"Content-Type": "application/json"},
                )
            if verdict.status != 101:
                writer.write(
                    _serialize_head(verdict, chunked=False, keep_alive=False)
                    + verdict.body
                )
                await writer.drain()
                return True  # handled: rejected before the handshake

        # handshake
        response = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(client_key)}\r\n\r\n"
        )
        writer.write(response.encode())
        await writer.drain()

        conn = Connection(client_key, reader, writer)
        conn._loop = asyncio.get_running_loop()  # type: ignore[attr-defined]
        manager = self.container.ws_manager
        if manager is not None:
            manager.add_connection(client_key, conn)

        from gofr_tpu_torch.context import Context
        from gofr_tpu_torch.handler import execute_handler

        async def _pong(payload: bytes) -> None:
            async with conn._write_lock:
                writer.write(_encode_frame(OP_PONG, payload))
                await writer.drain()

        from collections import deque

        pending: "deque[tuple[int, bytes]]" = deque()
        read_task: asyncio.Task | None = None

        def _ensure_read() -> asyncio.Task:
            nonlocal read_task
            if read_task is None:
                read_task = asyncio.create_task(read_message(reader, pong=_pong))
            return read_task

        try:
            while not conn.closed:
                if pending:
                    opcode, payload = pending.popleft()
                else:
                    try:
                        opcode, payload = await _ensure_read()
                    except (asyncio.IncompleteReadError, ConnectionResetError,
                            ConnectionError):
                        break
                    finally:
                        read_task = None
                if opcode == OP_CLOSE:
                    await conn.close()
                    break
                if opcode not in (OP_TEXT, OP_BINARY):
                    continue
                ctx = Context(_WSRequest(request, payload), self.container)
                ctx.websocket = conn
                # The wire stays serviced WHILE the handler runs: long
                # streaming handlers previously starved PING replies and
                # never saw a graceful CLOSE until generation finished —
                # pinning engine slots on departed clients. The reader
                # task persists across waits so no frame is ever lost
                # mid-read.
                handler_task = asyncio.create_task(execute_handler(handler, ctx))
                while not handler_task.done():
                    if len(pending) >= 32:
                        # backpressure: stop draining the socket so TCP
                        # flow control stalls an abusive pipeliner instead
                        # of buffering unbounded frames server-side
                        await handler_task
                        break
                    await asyncio.wait(
                        {handler_task, _ensure_read()},
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                    if read_task is not None and read_task.done():
                        try:
                            op2, pl2 = read_task.result()
                        except (asyncio.IncompleteReadError, ConnectionResetError,
                                ConnectionError):
                            conn.closed = True  # transport died: unwind sends
                            break
                        finally:
                            read_task = None
                        if op2 == OP_CLOSE:
                            await conn.close()  # handler unwinds on next send
                            break
                        if op2 in (OP_TEXT, OP_BINARY):
                            pending.append((op2, pl2))  # next iteration's input
                result = await handler_task
                if result.error is not None:
                    # the request/reply contract must hold on errors too: a
                    # silent drop leaves the client blocked on recv forever
                    self.container.logger.log_error(result.error)
                    if not conn.closed:
                        message = (
                            str(result.error)
                            if getattr(result.error, "status_code", 500) < 500
                            else "some unexpected error has occurred"
                        )
                        try:
                            await conn.send_async({"error": {"message": message}})
                        except (ConnectionError, OSError):
                            pass
                elif result.data is not None and not conn.closed:
                    await conn.send_async(result.data)
        finally:
            if read_task is not None:
                read_task.cancel()
            if manager is not None:
                manager.remove_connection(client_key)
            await conn.close()
        return True
