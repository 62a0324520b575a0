"""HTTP/2 (RFC 9113) and gRPC's framing over it, on asyncio: the port's own
transport in place of grpcio's C core, which ``gofr_tpu/grpcx`` rides and the
card's machine does not have.

The HTTP/2 layer (:class:`H2Connection`, :class:`H2Stream`) speaks the frames
gRPC uses, on either side of a prior-knowledge cleartext (h2c) connection:
the preface; SETTINGS with their ACK; HEADERS with CONTINUATION (HPACK,
``grpcx/hpack.py``); DATA under connection- and stream-level flow control in
both directions (a sender never exceeds the peer's windows, a receiver
returns window with WINDOW_UPDATE as the application consumes the bytes);
PING, answered with its ACK (grpcio sends BDP pings); RST_STREAM; GOAWAY for
a graceful stop.

The gRPC layer: the 5-byte message prefix (a compressed message is refused
with UNIMPLEMENTED: this side never offers an encoding), ``grpc-timeout`` in
each of its units, ``-bin`` metadata in base64, ``grpc-status`` and a
percent-encoded ``grpc-message`` in the trailers or in a trailers-only
response, and ``te: trailers`` with ``content-type: application/grpc`` on
both sides. :class:`RpcServer` serves method handlers (``grpcx/runtime.py``'s
records) on the running loop: a coroutine or async-generator behaviour runs
there, a plain function in the server's executor (as ``grpc.server`` with a
thread pool runs it); a peer's RST_STREAM or a lapsed deadline cancels the
handler's task. :class:`Channel` is the asyncio client (``grpc.aio``'s
multicallables and call objects), :class:`BlockingChannel` the blocking one,
on a loop thread of its own that never waits for a caller.

Every socket this module accepts or opens sets ``TCP_NODELAY``.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import enum
import inspect
import socket
import threading
import time
import urllib.parse
from typing import Any, AsyncIterator, Callable, Iterable

from gofr_tpu_torch.grpcx import hpack

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0x0, 0x1, 0x2, 0x3, 0x4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 0x5, 0x6, 0x7, 0x8, 0x9
# flags
FLAG_END_STREAM, FLAG_ACK, FLAG_END_HEADERS, FLAG_PADDED, FLAG_PRIORITY = 0x1, 0x1, 0x4, 0x8, 0x20
# settings
S_HEADER_TABLE_SIZE, S_ENABLE_PUSH, S_MAX_CONCURRENT_STREAMS = 0x1, 0x2, 0x3
S_INITIAL_WINDOW_SIZE, S_MAX_FRAME_SIZE, S_MAX_HEADER_LIST_SIZE = 0x4, 0x5, 0x6
# error codes
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, 0x2, 0x3
STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL = 0x5, 0x6, 0x7, 0x8
COMPRESSION_ERROR = 0x9

DEFAULT_WINDOW = 65535
DEFAULT_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
# return receive window once this much of it has been consumed
WINDOW_RETURN_AT = DEFAULT_WINDOW // 4
# the connection-level receive window this side opens at start: streams keep
# the default 65,535 each, so one stream a reader leaves unread cannot hold
# back the others on the connection
CONN_RECV_WINDOW = 1 << 24

USER_AGENT = "gofr-tpu-torch-grpc/1.0"
# a blocking call made without a timeout gets this deadline: no caller's
# thread parks unbounded on a dark peer
BLOCKING_DEFAULT_TIMEOUT_S = 300.0


class StatusCode(enum.Enum):
    """gRPC status codes, with ``grpc.StatusCode``'s names and values."""

    OK = (0, "ok")
    CANCELLED = (1, "cancelled")
    UNKNOWN = (2, "unknown")
    INVALID_ARGUMENT = (3, "invalid argument")
    DEADLINE_EXCEEDED = (4, "deadline exceeded")
    NOT_FOUND = (5, "not found")
    ALREADY_EXISTS = (6, "already exists")
    PERMISSION_DENIED = (7, "permission denied")
    RESOURCE_EXHAUSTED = (8, "resource exhausted")
    FAILED_PRECONDITION = (9, "failed precondition")
    ABORTED = (10, "aborted")
    OUT_OF_RANGE = (11, "out of range")
    UNIMPLEMENTED = (12, "unimplemented")
    INTERNAL = (13, "internal")
    UNAVAILABLE = (14, "unavailable")
    DATA_LOSS = (15, "data loss")
    UNAUTHENTICATED = (16, "unauthenticated")


_CODE_BY_INT = {c.value[0]: c for c in StatusCode}


def code_of(number: int) -> StatusCode:
    return _CODE_BY_INT.get(number, StatusCode.UNKNOWN)


class RpcError(Exception):
    """A call that ended with a status other than OK (``grpc.aio.AioRpcError``
    and ``grpc.RpcError`` in one)."""

    def __init__(self, code: StatusCode, details: str = "",
                 trailing_metadata: tuple = (), initial_metadata: tuple = ()) -> None:
        super().__init__(f"<RpcError {code.name}: {details}>")
        self._code = code
        self._details = details
        self._trailing = tuple(trailing_metadata)
        self._initial = tuple(initial_metadata)

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> tuple:
        return self._trailing

    def initial_metadata(self) -> tuple:
        return self._initial


class AbortError(Exception):
    """Raised by ``ServicerContext.abort``: ends the RPC with its status."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(details)
        self.code = code
        self.details = details


class H2ProtocolError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


class StreamReset(Exception):
    """The stream was reset (by the peer or locally) or its connection lost."""

    def __init__(self, code: int, message: str = "") -> None:
        super().__init__(message or f"stream reset with error code {code}")
        self.code = code


# -- gRPC framing helpers -----------------------------------------------------

def encode_message(payload: bytes) -> bytes:
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


class MessageAssembler:
    """Length-prefixed gRPC messages out of DATA payloads as they arrive."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        self._buf += data
        out = []
        while len(self._buf) >= 5:
            if self._buf[0] == 1:
                raise AbortError(StatusCode.UNIMPLEMENTED,
                                 "compressed messages are not supported (no grpc-encoding offered)")
            if self._buf[0] != 0:
                raise AbortError(StatusCode.INTERNAL, "bad message compression flag")
            n = int.from_bytes(self._buf[1:5], "big")
            if len(self._buf) < 5 + n:
                break
            out.append(bytes(self._buf[5:5 + n]))
            del self._buf[:5 + n]
        return out

    @property
    def pending(self) -> bool:
        return bool(self._buf)


_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


def encode_timeout(seconds: float) -> str:
    """The smallest unit whose count fits the 8 digits gRPC allows."""
    seconds = max(0.0, seconds)
    for unit, scale in (("n", 1e-9), ("u", 1e-6), ("m", 1e-3), ("S", 1.0),
                        ("M", 60.0), ("H", 3600.0)):
        count = int(-(-seconds // scale)) if unit in "HMS" else int(round(seconds / scale))
        if count < 100_000_000:
            return f"{max(count, 1 if seconds > 0 else 0)}{unit}"
    return "99999999H"


def decode_timeout(value: str) -> float:
    value = value.strip()
    if len(value) < 2 or value[-1] not in _TIMEOUT_UNITS or not value[:-1].isdigit() \
            or len(value) > 9:
        raise ValueError(f"bad grpc-timeout {value!r}")
    return int(value[:-1]) * _TIMEOUT_UNITS[value[-1]]


def encode_grpc_message(message: str) -> str:
    """gRPC's percent-encoding: bytes outside 0x20-0x7E, and '%', escaped."""
    out = []
    for b in message.encode("utf-8"):
        if 0x20 <= b <= 0x7E and b != 0x25:
            out.append(chr(b))
        else:
            out.append(f"%{b:02X}")
    return "".join(out)


def decode_grpc_message(value: str) -> str:
    return urllib.parse.unquote(value, errors="replace")


_RESERVED = {"content-type", "te", "grpc-timeout", "grpc-encoding", "grpc-accept-encoding",
             "grpc-status", "grpc-message", "grpc-status-details-bin",
             "content-length", "connection", "host"}


def metadata_headers(metadata: Iterable[tuple[str, Any]] | None) -> list[tuple[str, str]]:
    out = []
    for key, value in metadata or ():
        key = key.lower()
        if key.endswith("-bin"):
            if isinstance(value, str):
                value = value.encode("utf-8")
            value = base64.b64encode(bytes(value)).decode("ascii").rstrip("=")
        out.append((key, str(value)))
    return out


def headers_metadata(headers: list[tuple[str, str]]) -> tuple:
    out = []
    for key, value in headers:
        if key.startswith(":") or key in _RESERVED:
            continue
        if key.endswith("-bin"):
            out.append((key, base64.b64decode(value + "=" * (-len(value) % 4))))
        else:
            out.append((key, value))
    return tuple(out)


def _http_status_code(status: str) -> StatusCode:
    return {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
            "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
            "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
            "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE,
            }.get(status, StatusCode.UNKNOWN)


def _set_nodelay(writer: asyncio.StreamWriter) -> None:
    sock = writer.get_extra_info("socket")
    if sock is not None and sock.family in (socket.AF_INET, socket.AF_INET6):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


# -- HTTP/2 -------------------------------------------------------------------

class H2Stream:
    """One stream: received headers and data as events, send window, state."""

    def __init__(self, conn: "H2Connection", sid: int) -> None:
        self.conn = conn
        self.id = sid
        self.send_window = conn.peer_initial_window
        self.events: asyncio.Queue = asyncio.Queue()
        self.local_closed = False
        self.remote_closed = False
        self.reset_code: int | None = None
        self.unacked = 0  # consumed bytes whose window is not returned yet
        self.on_reset: Callable[[int], None] | None = None

    @property
    def closed(self) -> bool:
        return self.reset_code is not None or (self.local_closed and self.remote_closed)

    async def next_event(self) -> tuple:
        """("headers", list, end_stream) | ("data", bytes, end_stream) |
        ("reset", code). Data handed out here is consumed: its window goes
        back to the peer."""
        ev = await self.events.get()
        if ev[0] == "data" and ev[1]:
            self.conn._consumed(self, len(ev[1]))
        return ev

    def send_headers(self, headers: list[tuple[str, str]], end_stream: bool = False) -> None:
        self._check_open()
        self.conn._send_headers(self.id, headers, end_stream)
        if end_stream:
            self._close_local()

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        self._check_open()
        await self.conn._send_data(self, data, end_stream)
        if end_stream:
            self._close_local()

    def reset(self, code: int = CANCEL) -> None:
        if self.reset_code is not None:
            return
        self.reset_code = code
        self.conn._send_rst(self.id, code)
        self.conn._forget(self)
        self.events.put_nowait(("reset", code))

    def _check_open(self) -> None:
        if self.reset_code is not None:
            raise StreamReset(self.reset_code)
        if self.local_closed:
            raise StreamReset(STREAM_CLOSED, "stream already half-closed")

    def _close_local(self) -> None:
        self.local_closed = True
        if self.closed:
            self.conn._forget(self)

    def _peer_reset(self, code: int) -> None:
        if self.reset_code is not None:
            return
        self.reset_code = code
        self.conn._forget(self)
        self.events.put_nowait(("reset", code))
        if self.on_reset is not None:
            self.on_reset(code)


class H2Connection:
    """One HTTP/2 connection over asyncio streams, client or server side.
    ``on_stream(stream, headers, end_stream)`` (server side) is called on the
    loop for each new stream the peer opens."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                 client: bool, on_stream: Callable | None = None) -> None:
        self.reader, self.writer = reader, writer
        self.client = client
        self.on_stream = on_stream
        self.encoder = hpack.Encoder()
        self.decoder = hpack.Decoder()
        self.streams: dict[int, H2Stream] = {}
        self.next_stream_id = 1 if client else 2
        self.last_peer_stream = 0
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_FRAME
        self.send_window = DEFAULT_WINDOW
        self.unacked = 0
        self.closed = False
        self.goaway_received = False
        self.goaway_sent = False
        self._flow = asyncio.Condition()
        self._continuation: tuple[int, int, bytearray] | None = None
        self._reader_task: asyncio.Task | None = None
        self._closed_event = asyncio.Event()
        peer = writer.get_extra_info("peername")
        self.peer = peer if isinstance(peer, tuple) else ("", 0)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        _set_nodelay(self.writer)
        if self.client:
            self.writer.write(PREFACE)
            self._send_frame(SETTINGS, 0, 0, _settings_payload({S_ENABLE_PUSH: 0}))
        else:
            # the server's preface is its SETTINGS, sent before reading
            self._send_frame(SETTINGS, 0, 0, _settings_payload({S_MAX_CONCURRENT_STREAMS: 1000}))
        self._send_frame(WINDOW_UPDATE, 0, 0,
                         (CONN_RECV_WINDOW - DEFAULT_WINDOW).to_bytes(4, "big"))
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def wait_closed(self) -> None:
        await self._closed_event.wait()

    def goaway(self, code: int = NO_ERROR, message: str = "") -> None:
        """Announce the last stream this side will serve; streams already
        open go on (a graceful stop)."""
        if self.closed or self.goaway_sent:
            return
        self.goaway_sent = True
        payload = self.last_peer_stream.to_bytes(4, "big") + code.to_bytes(4, "big") \
            + message.encode()
        self._send_frame(GOAWAY, 0, 0, payload)

    def close(self) -> None:
        if not self.closed:
            self.goaway()
        self._teardown()

    def open_stream(self) -> H2Stream:
        if self.closed or self.goaway_received:
            raise StreamReset(REFUSED_STREAM, "connection is closing")
        sid = self.next_stream_id
        self.next_stream_id += 2
        stream = H2Stream(self, sid)
        self.streams[sid] = stream
        return stream

    @property
    def usable(self) -> bool:
        return not (self.closed or self.goaway_received or self.goaway_sent) \
            and self.next_stream_id < MAX_WINDOW

    # -- sending ------------------------------------------------------------
    def _send_frame(self, ftype: int, flags: int, sid: int, payload: bytes = b"") -> None:
        if self.closed:
            raise StreamReset(CANCEL, "connection closed")
        self.writer.write(len(payload).to_bytes(3, "big") + bytes((ftype, flags))
                          + sid.to_bytes(4, "big") + payload)

    def _send_headers(self, sid: int, headers: list[tuple[str, str]], end_stream: bool) -> None:
        block = self.encoder.encode(headers)
        size = self.peer_max_frame
        first, rest = block[:size], block[size:]
        flags = (FLAG_END_STREAM if end_stream else 0) | (0 if rest else FLAG_END_HEADERS)
        frames = [(HEADERS, flags, first)]
        while rest:
            chunk, rest = rest[:size], rest[size:]
            frames.append((CONTINUATION, 0 if rest else FLAG_END_HEADERS, chunk))
        if self.closed:
            raise StreamReset(CANCEL, "connection closed")
        # one write: nothing may come between a HEADERS and its CONTINUATIONs
        self.writer.write(b"".join(
            len(p).to_bytes(3, "big") + bytes((t, f)) + sid.to_bytes(4, "big") + p
            for t, f, p in frames))

    async def _send_data(self, stream: H2Stream, data: bytes, end_stream: bool) -> None:
        view = memoryview(data)
        while True:
            if not view:
                if end_stream:
                    self._send_frame(DATA, FLAG_END_STREAM, stream.id)
                break
            if stream.reset_code is not None:
                raise StreamReset(stream.reset_code)
            if self.closed:
                raise StreamReset(CANCEL, "connection closed")
            if min(self.send_window, stream.send_window) <= 0:
                async with self._flow:
                    await self._flow.wait_for(
                        lambda: min(self.send_window, stream.send_window) > 0
                        or self.closed or stream.reset_code is not None)
                continue
            n = min(len(view), self.send_window, stream.send_window, self.peer_max_frame)
            chunk, view = view[:n], view[n:]
            self.send_window -= n
            stream.send_window -= n
            last = end_stream and not view
            self._send_frame(DATA, FLAG_END_STREAM if last else 0, stream.id, bytes(chunk))
            if last:
                break
        try:
            await self.writer.drain()
        except (ConnectionError, OSError) as exc:
            raise StreamReset(CANCEL, f"connection lost: {exc}") from None

    def _send_rst(self, sid: int, code: int) -> None:
        if not self.closed:
            self._send_frame(RST_STREAM, 0, sid, code.to_bytes(4, "big"))

    def _consumed(self, stream: H2Stream, n: int) -> None:
        """The application took ``n`` bytes: give the window back in batches."""
        self.unacked += n
        if self.unacked >= WINDOW_RETURN_AT and not self.closed:
            self._send_frame(WINDOW_UPDATE, 0, 0, self.unacked.to_bytes(4, "big"))
            self.unacked = 0
        stream.unacked += n
        if stream.unacked >= WINDOW_RETURN_AT and not stream.remote_closed \
                and stream.reset_code is None and not self.closed:
            self._send_frame(WINDOW_UPDATE, 0, stream.id, stream.unacked.to_bytes(4, "big"))
            stream.unacked = 0

    def _forget(self, stream: H2Stream) -> None:
        self.streams.pop(stream.id, None)

    # -- receiving ----------------------------------------------------------
    async def _read_loop(self) -> None:
        try:
            if not self.client:
                preface = await self.reader.readexactly(len(PREFACE))
                if preface != PREFACE:
                    raise H2ProtocolError(PROTOCOL_ERROR, "bad connection preface")
            while True:
                head = await self.reader.readexactly(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
                if length > DEFAULT_FRAME:
                    raise H2ProtocolError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
                payload = await self.reader.readexactly(length) if length else b""
                if self._continuation is not None and ftype != CONTINUATION:
                    raise H2ProtocolError(PROTOCOL_ERROR, "expected CONTINUATION")
                await self._on_frame(ftype, flags, sid, payload)
        except H2ProtocolError as exc:
            try:
                self.goaway(exc.code, str(exc))
            except StreamReset:
                pass
        except hpack.HPACKError as exc:
            try:
                self.goaway(COMPRESSION_ERROR, str(exc))
            except StreamReset:
                pass
        except (asyncio.IncompleteReadError, ConnectionError, OSError, asyncio.CancelledError):
            pass
        finally:
            self._teardown()

    def _teardown(self) -> None:
        if self.closed:
            return
        self.closed = True
        for stream in list(self.streams.values()):
            stream._peer_reset(CANCEL)
        self.streams.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        self._closed_event.set()
        asyncio.ensure_future(self._notify_flow())
        task = self._reader_task
        if task is not None and task is not asyncio.current_task() and not task.done():
            task.cancel()

    async def _notify_flow(self) -> None:
        async with self._flow:
            self._flow.notify_all()

    async def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype in (HEADERS, CONTINUATION):
            self._on_headers_frame(ftype, flags, sid, payload)
        elif ftype == RST_STREAM:
            if sid == 0 or len(payload) != 4:
                raise H2ProtocolError(PROTOCOL_ERROR, "bad RST_STREAM")
            stream = self.streams.get(sid)
            if stream is not None:
                stream._peer_reset(int.from_bytes(payload, "big"))
                await self._notify_flow()
        elif ftype == SETTINGS:
            await self._on_settings(flags, sid, payload)
        elif ftype == PING:
            if sid != 0 or len(payload) != 8:
                raise H2ProtocolError(PROTOCOL_ERROR, "bad PING")
            if not flags & FLAG_ACK:
                self._send_frame(PING, FLAG_ACK, 0, payload)
        elif ftype == GOAWAY:
            self.goaway_received = True
            last = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            for stream in list(self.streams.values()):
                if stream.id > last and (stream.id % 2 == 1) == self.client:
                    stream._peer_reset(REFUSED_STREAM)
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2ProtocolError(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if sid == 0:
                if inc == 0:
                    raise H2ProtocolError(PROTOCOL_ERROR, "zero window increment")
                self.send_window += inc
                if self.send_window > MAX_WINDOW:
                    raise H2ProtocolError(FLOW_CONTROL_ERROR, "connection window overflow")
            else:
                stream = self.streams.get(sid)
                if stream is not None:
                    if inc == 0:
                        stream.reset(PROTOCOL_ERROR)
                    else:
                        stream.send_window += inc
                        if stream.send_window > MAX_WINDOW:
                            stream.reset(FLOW_CONTROL_ERROR)
            await self._notify_flow()
        elif ftype == PUSH_PROMISE:
            raise H2ProtocolError(PROTOCOL_ERROR, "push is disabled")
        # PRIORITY and unknown frame types are ignored

    def _strip_padding(self, flags: int, payload: bytes) -> bytes:
        if flags & FLAG_PADDED:
            if not payload:
                raise H2ProtocolError(PROTOCOL_ERROR, "padded frame without a pad length")
            pad = payload[0]
            if pad >= len(payload):
                raise H2ProtocolError(PROTOCOL_ERROR, "padding exceeds the frame")
            return payload[1:len(payload) - pad]
        return payload

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise H2ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
        data = self._strip_padding(flags, payload)
        stream = self.streams.get(sid)
        # padding and data for a stream that is gone are consumed at once
        overhead = len(payload) - len(data)
        if stream is None or stream.remote_closed:
            overhead = len(payload)
        if overhead:
            self.unacked += overhead
            if self.unacked >= WINDOW_RETURN_AT:
                self._send_frame(WINDOW_UPDATE, 0, 0, self.unacked.to_bytes(4, "big"))
                self.unacked = 0
        if stream is None:
            return
        if stream.remote_closed:
            stream.reset(STREAM_CLOSED)
            return
        end = bool(flags & FLAG_END_STREAM)
        if end:
            stream.remote_closed = True
        stream.events.put_nowait(("data", data, end))
        if end and stream.closed:
            self._forget(stream)

    def _on_headers_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if ftype == HEADERS:
            if sid == 0:
                raise H2ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
            payload = self._strip_padding(flags, payload)
            if flags & FLAG_PRIORITY:
                payload = payload[5:]
            self._continuation = (sid, flags, bytearray(payload))
        else:
            if self._continuation is None or self._continuation[0] != sid:
                raise H2ProtocolError(PROTOCOL_ERROR, "unexpected CONTINUATION")
            self._continuation[2].extend(payload)
            flags = self._continuation[1] | (flags & FLAG_END_HEADERS)
        if not flags & FLAG_END_HEADERS:
            return
        sid, first_flags, block = self._continuation
        self._continuation = None
        headers = self.decoder.decode(bytes(block))  # always: keeps HPACK state
        end = bool(first_flags & FLAG_END_STREAM)
        stream = self.streams.get(sid)
        if stream is None:
            if self.client or sid % 2 == 0 or sid <= self.last_peer_stream:
                return  # a stream we reset or forgot: ignored
            self.last_peer_stream = sid
            if self.goaway_sent:
                self._send_rst(sid, REFUSED_STREAM)
                return
            stream = H2Stream(self, sid)
            self.streams[sid] = stream
            if end:
                stream.remote_closed = True
            if self.on_stream is not None:
                self.on_stream(stream, headers, end)
            return
        if stream.remote_closed:
            stream.reset(STREAM_CLOSED)
            return
        if end:
            stream.remote_closed = True
        stream.events.put_nowait(("headers", headers, end))
        if end and stream.closed:
            self._forget(stream)

    async def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2ProtocolError(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & FLAG_ACK:
            return
        if len(payload) % 6:
            raise H2ProtocolError(FRAME_SIZE_ERROR, "bad SETTINGS length")
        for i in range(0, len(payload), 6):
            ident = int.from_bytes(payload[i:i + 2], "big")
            value = int.from_bytes(payload[i + 2:i + 6], "big")
            if ident == S_INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2ProtocolError(FLOW_CONTROL_ERROR, "initial window too large")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for stream in self.streams.values():
                    stream.send_window += delta
            elif ident == S_MAX_FRAME_SIZE:
                if not DEFAULT_FRAME <= value <= (1 << 24) - 1:
                    raise H2ProtocolError(PROTOCOL_ERROR, "bad max frame size")
                self.peer_max_frame = value
        self._send_frame(SETTINGS, FLAG_ACK, 0)
        await self._notify_flow()


def _settings_payload(settings: dict[int, int]) -> bytes:
    return b"".join(k.to_bytes(2, "big") + v.to_bytes(4, "big") for k, v in settings.items())


# -- the gRPC server ----------------------------------------------------------

class ServicerContext:
    """What a handler is handed beside its request (``grpc.aio.ServicerContext``
    and the sync ``grpc.ServicerContext`` in one): ``abort`` raises at once,
    so ``await context.abort(...)`` and ``context.abort(...)`` both end the
    RPC."""

    def __init__(self, call: "_ServerCall") -> None:
        self._call = call
        self._trailing: tuple = ()

    def invocation_metadata(self) -> tuple:
        return self._call.metadata

    def time_remaining(self) -> float | None:
        deadline = self._call.deadline
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def abort(self, code: StatusCode, details: str = "") -> None:
        raise AbortError(code, details)

    def set_trailing_metadata(self, metadata: Iterable[tuple[str, Any]]) -> None:
        self._trailing = tuple(metadata)

    def peer(self) -> str:
        host, port = self._call.stream.conn.peer[:2]
        return f"ipv6:[{host}]:{port}" if ":" in str(host) else f"ipv4:{host}:{port}"

    def cancelled(self) -> bool:
        return self._call.cancelled



class _ServerCall:
    def __init__(self, server: "RpcServer", stream: H2Stream, headers: list,
                 end_stream: bool) -> None:
        self.server = server
        self.stream = stream
        self.headers = dict(headers)
        self.metadata = headers_metadata(headers)
        self.deadline: float | None = None
        self.cancelled = False
        self.finished = False
        self.timed_out = False
        self.headers_sent = False
        self.assembler = MessageAssembler()
        self.messages: collections.deque = collections.deque()
        # from the HEADERS frame alone: the stream's own flag may already
        # count a DATA frame still queued for this call
        self.request_done = end_stream

    def send_initial(self) -> None:
        if self.headers_sent:
            return
        self.headers_sent = True
        self.stream.send_headers([(":status", "200"), ("content-type", "application/grpc"),
                                  ("grpc-accept-encoding", "identity")])

    async def next_request(self) -> bytes | None:
        while not self.messages:
            if self.request_done:
                if self.assembler.pending:
                    raise AbortError(StatusCode.INTERNAL, "truncated request message")
                return None
            ev = await self.stream.next_event()
            if ev[0] == "reset":
                raise asyncio.CancelledError()
            if ev[0] == "data":
                self.messages.extend(self.assembler.feed(ev[1]))
            if ev[2]:
                self.request_done = True
        return self.messages.popleft()

    async def send_message(self, payload: bytes) -> None:
        self.send_initial()
        await self.stream.send_data(encode_message(payload))

    def finish(self, code: StatusCode, details: str, trailing: tuple) -> None:
        self.finished = True
        if self.stream.reset_code is not None or self.stream.conn.closed:
            return
        status = [("grpc-status", str(code.value[0]))]
        if details:
            status.append(("grpc-message", encode_grpc_message(details)))
        status += metadata_headers(trailing)
        if self.headers_sent:
            self.stream.send_headers(status, end_stream=True)
        else:  # trailers-only
            self.stream.send_headers([(":status", "200"), ("content-type", "application/grpc"),
                                      *status], end_stream=True)
        if not self.stream.remote_closed and self.stream.reset_code is None:
            self.stream.reset(NO_ERROR)  # the client need send no more


def _no_method(_path: str) -> None:
    return None


class RpcServer:
    """The serving half: accept h2c connections and run each RPC through the
    handler ``lookup(path)`` returns (``None``: UNIMPLEMENTED). Behaviours
    that are plain functions run in ``executor`` (the loop's default when
    ``None``)."""

    def __init__(self, lookup: Callable[[str], Any], executor: Any = None) -> None:
        self.lookup = lookup
        self.executor = executor
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[H2Connection] = set()
        self._tasks: set[asyncio.Task] = set()
        self.port = 0

    async def start(self, host: str | None, port: int) -> int:
        self._server = await asyncio.start_server(self._accept, host=host, port=port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = H2Connection(reader, writer, client=False, on_stream=self._on_stream)
        self._conns.add(conn)
        conn.start()
        try:
            await conn.wait_closed()
        finally:
            self._conns.discard(conn)

    def _on_stream(self, stream: H2Stream, headers: list, end_stream: bool) -> None:
        task = asyncio.ensure_future(self._serve(stream, headers, end_stream))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _serve(self, stream: H2Stream, headers: list, end_stream: bool) -> None:
        call = _ServerCall(self, stream, headers, end_stream)
        ctx = ServicerContext(call)
        task = asyncio.current_task()

        def on_reset(_code: int) -> None:
            call.cancelled = True
            if not call.finished:
                task.cancel()

        stream.on_reset = on_reset
        h = call.headers
        if h.get(":method") != "POST" or not h.get("content-type", "").startswith("application/grpc"):
            try:
                stream.send_headers([(":status", "415")], end_stream=True)
                if not stream.remote_closed:
                    stream.reset(NO_ERROR)
            except StreamReset:
                pass
            return
        timer = None
        if "grpc-timeout" in h:
            try:
                timeout = decode_timeout(h["grpc-timeout"])
            except ValueError:
                timeout = None
            if timeout is not None:
                call.deadline = time.monotonic() + timeout

                def expire() -> None:
                    call.timed_out = True
                    if not call.finished:
                        task.cancel()

                timer = asyncio.get_running_loop().call_later(timeout, expire)
        code, details = StatusCode.OK, ""
        try:
            try:
                handler = self.lookup(h.get(":path", ""))
                if handler is None:
                    raise AbortError(StatusCode.UNIMPLEMENTED, "Method not found!")
                if h.get("grpc-encoding", "identity") != "identity":
                    raise AbortError(StatusCode.UNIMPLEMENTED,
                                     f"grpc-encoding {h['grpc-encoding']} is not supported")
                await self._run(handler, call, ctx)
            except AbortError as exc:
                code, details = exc.code, exc.details
            except asyncio.CancelledError:
                if not call.timed_out:
                    return  # the client reset the stream: nothing to answer
                code, details = StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded"
            except Exception as exc:
                code, details = StatusCode.UNKNOWN, f"Unexpected {type(exc)}: {exc}"
            call.finish(code, details, ctx._trailing)
        except (StreamReset, ConnectionError, OSError):
            pass
        finally:
            call.finished = True
            if timer is not None:
                timer.cancel()

    async def _run(self, handler: Any, call: _ServerCall, ctx: ServicerContext) -> None:
        deserialize = handler.request_deserializer or (lambda b: b)
        serialize = handler.response_serializer or (lambda m: m)

        def parse(raw: bytes) -> Any:
            try:
                return deserialize(raw)
            except Exception:
                raise AbortError(StatusCode.INTERNAL, "Exception deserializing request!") from None

        if handler.request_streaming:
            async def requests() -> AsyncIterator[Any]:
                while True:
                    raw = await call.next_request()
                    if raw is None:
                        return
                    yield parse(raw)

            request: Any = requests()
        else:
            raw = await call.next_request()
            if raw is None:
                raise AbortError(StatusCode.INTERNAL, "Missing request message")
            if await call.next_request() is not None:
                raise AbortError(StatusCode.UNIMPLEMENTED, "Too many request messages")
            request = parse(raw)
        behavior = handler.behavior
        if handler.response_streaming:
            responses = behavior(request, ctx)
            if inspect.iscoroutine(responses):
                responses = await responses
            if hasattr(responses, "__aiter__"):
                try:
                    async for msg in responses:
                        await call.send_message(serialize(msg))
                finally:
                    aclose = getattr(responses, "aclose", None)
                    if aclose is not None:
                        await aclose()
            else:
                for msg in responses or ():
                    await call.send_message(serialize(msg))
            return
        if asyncio.iscoroutinefunction(behavior) or inspect.isasyncgenfunction(behavior):
            result = await behavior(request, ctx)
        else:
            loop = asyncio.get_running_loop()
            result = await loop.run_in_executor(self.executor, behavior, request, ctx)
            if inspect.iscoroutine(result):
                result = await result
        await call.send_message(serialize(result))

    async def stop(self, grace: float | None = None) -> None:
        """GOAWAY to every connection, then wait up to ``grace`` seconds for
        the RPCs in flight; cancel what is left and close."""
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns):
            try:
                conn.goaway()
            except StreamReset:
                pass
        if self._tasks and grace:
            await asyncio.wait(list(self._tasks), timeout=grace)
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.wait(list(self._tasks), timeout=1.0)
        for conn in list(self._conns):
            conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
            self._server = None
        # a stopped server resolves no method: the connections torn down
        # above stay in reference cycles until a collection, and through
        # the lookup they would keep every servicer (an engine and its
        # weights on the card) alive that long
        self.lookup = _no_method


# -- the gRPC client ----------------------------------------------------------

def parse_target(target: str) -> tuple[str, int]:
    for prefix in ("dns:///", "ipv4:", "ipv6:", "dns:"):
        if target.startswith(prefix):
            target = target[len(prefix):]
    if target.startswith("["):
        host, _, port = target[1:].partition("]:")
    else:
        host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad gRPC target {target!r}: want host:port")
    return host, int(port)


class _ClientCall:
    """One RPC on a :class:`Channel`: send the request side, read messages
    and the status."""

    def __init__(self, channel: "Channel", path: str, serializer: Callable | None,
                 deserializer: Callable | None, timeout: float | None,
                 metadata: Iterable | None) -> None:
        self.channel = channel
        self.path = path
        self.serialize = serializer or (lambda m: m)
        self.deserialize = deserializer or (lambda b: b)
        self.deadline = time.monotonic() + timeout if timeout is not None else None
        self.metadata = tuple(metadata or ())
        self.stream: H2Stream | None = None
        self.assembler = MessageAssembler()
        self.pending: collections.deque = collections.deque()
        self.initial: tuple = ()
        self.got_headers = False
        self.code: StatusCode | None = None
        self.details = ""
        self.trailing: tuple = ()
        self.cancelled = False
        self.ended = False
        self._sender: asyncio.Task | None = None

    def _remaining(self) -> float | None:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def _fail(self, code: StatusCode, details: str) -> RpcError:
        if self.code is None:
            self.code, self.details = code, details
        self.ended = True
        return RpcError(self.code, self.details, self.trailing, self.initial)

    async def _bounded(self, aw: Any) -> Any:
        remaining = self._remaining()
        if remaining is None:
            return await aw
        if remaining <= 0:
            if inspect.iscoroutine(aw):
                aw.close()
            raise asyncio.TimeoutError()
        return await asyncio.wait_for(aw, remaining)

    async def start(self) -> None:
        try:
            conn = await self._bounded(self.channel._connection())
            self.stream = conn.open_stream()
            host, port = self.channel.host, self.channel.port
            headers = [(":method", "POST"), (":scheme", "http"), (":path", self.path),
                       (":authority", f"{host}:{port}"), ("content-type", "application/grpc"),
                       ("te", "trailers"), ("user-agent", USER_AGENT),
                       ("grpc-accept-encoding", "identity")]
            remaining = self._remaining()
            if remaining is not None:
                headers.append(("grpc-timeout", encode_timeout(remaining)))
            headers += metadata_headers(self.metadata)
            self.stream.send_headers(headers)
        except asyncio.TimeoutError:
            raise self._fail(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except (OSError, StreamReset) as exc:
            raise self._fail(StatusCode.UNAVAILABLE, f"failed to connect to "
                             f"{self.channel.target}: {exc}") from None

    async def send(self, message: Any, end: bool = False) -> None:
        try:
            await self._bounded(self.stream.send_data(encode_message(self.serialize(message)), end))
        except asyncio.TimeoutError:
            self._on_deadline()
        except StreamReset:
            pass  # the reading side reports the status

    async def end_requests(self) -> None:
        try:
            await self.stream.send_data(b"", end_stream=True)
        except StreamReset:
            pass

    def send_all(self, requests: Any) -> None:
        """Send a request iterator (sync or async) in a task of its own."""

        async def pump() -> None:
            try:
                if hasattr(requests, "__aiter__"):
                    async for msg in requests:
                        await self.send(msg)
                else:
                    for msg in requests:
                        await self.send(msg)
                await self.end_requests()
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # a failing iterator cancels the call
                self.cancel(StatusCode.UNKNOWN, f"request iterator raised: {exc}")

        self._sender = asyncio.ensure_future(pump())

    def _on_deadline(self) -> None:
        if self.stream is not None and self.stream.reset_code is None:
            try:
                self.stream.reset(CANCEL)
            except StreamReset:
                pass
        self._fail(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")

    def cancel(self, code: StatusCode = StatusCode.CANCELLED,
               details: str = "Locally cancelled by application!") -> bool:
        if self.ended:
            return False
        self.cancelled = code == StatusCode.CANCELLED
        if self.stream is not None and self.stream.reset_code is None:
            try:
                self.stream.reset(CANCEL)
            except StreamReset:
                pass
        self._fail(code, details)
        if self._sender is not None:
            self._sender.cancel()
        return True

    async def read(self) -> Any:
        """The next response message, or ``None`` after an OK status; raises
        :class:`RpcError` on any other."""
        while True:
            if self.pending:
                return self.deserialize(self.pending.popleft())
            if self.ended:
                if self.cancelled:
                    raise asyncio.CancelledError()
                if self.code in (None, StatusCode.OK):
                    return None
                raise RpcError(self.code, self.details, self.trailing, self.initial)
            try:
                ev = await self._bounded(self.stream.next_event())
            except asyncio.TimeoutError:
                self._on_deadline()
                continue
            kind = ev[0]
            if kind == "reset":
                if self.code is None:
                    code = {REFUSED_STREAM: StatusCode.UNAVAILABLE,
                            CANCEL: StatusCode.CANCELLED}.get(ev[1], StatusCode.INTERNAL)
                    detail = ("connection closed" if self.stream.conn.closed
                              else f"Received RST_STREAM with error code {ev[1]}")
                    if code == StatusCode.CANCELLED and self.stream.conn.closed:
                        code = StatusCode.UNAVAILABLE
                    self._fail(code, detail)
                self.ended = True
                continue
            if kind == "headers":
                self._on_headers(ev[1], ev[2])
            elif kind == "data":
                try:
                    self.pending.extend(self.assembler.feed(ev[1]))
                except AbortError as exc:
                    self.cancel(exc.code, exc.details)
                    self.cancelled = False
                if ev[2]:
                    self._fail(StatusCode.INTERNAL, "server closed the stream without a status")

    def _on_headers(self, headers: list, end: bool) -> None:
        h = dict(headers)
        if not self.got_headers:
            self.got_headers = True
            status = h.get(":status")
            if status != "200":
                if not end:
                    self.stream.reset(CANCEL)
                self._fail(_http_status_code(str(status)), f"HTTP status {status}")
                return
            if not end:
                self.initial = headers_metadata(headers)
                return
        if "grpc-status" in h:
            self.trailing = headers_metadata(headers)
            try:
                code = code_of(int(h["grpc-status"]))
            except ValueError:
                code = StatusCode.UNKNOWN
            self.code = code
            self.details = decode_grpc_message(h.get("grpc-message", ""))
            self.ended = True
        elif end:
            self._fail(StatusCode.INTERNAL, "trailers without grpc-status")


class UnaryStreamCall:
    """The call object of a response-streaming RPC (``grpc.aio``'s): iterate
    it for messages; ``cancel()`` resets the stream."""

    def __init__(self, call: _ClientCall, start: Callable) -> None:
        self._call = call
        self._start = start
        self._started = False

    async def _ensure(self) -> None:
        if not self._started:
            self._started = True
            await self._start()

    def __aiter__(self) -> AsyncIterator[Any]:
        return self._iterate()

    async def _iterate(self) -> AsyncIterator[Any]:
        try:
            await self._ensure()
            while True:
                msg = await self._call.read()
                if msg is None:
                    return
                yield msg
        finally:
            if not self._call.ended:
                self._call.cancel()

    def cancel(self) -> bool:
        return self._call.cancel()

    async def code(self) -> StatusCode | None:
        return self._call.code

    async def details(self) -> str:
        return self._call.details

    async def trailing_metadata(self) -> tuple:
        return self._call.trailing


class _MultiCallable:
    def __init__(self, channel: "Channel", path: str, request_serializer: Callable | None,
                 response_deserializer: Callable | None) -> None:
        self.channel = channel
        self.path = path
        self.serialize = request_serializer
        self.deserialize = response_deserializer

    def _call(self, timeout: float | None, metadata: Any) -> _ClientCall:
        return _ClientCall(self.channel, self.path, self.serialize, self.deserialize,
                           timeout, metadata)


async def _single_response(call: _ClientCall) -> Any:
    response = await call.read()
    if response is None:
        raise RpcError(StatusCode.INTERNAL, "no response message", call.trailing, call.initial)
    if await call.read() is not None:
        raise RpcError(StatusCode.INTERNAL, "too many response messages")
    return response


class UnaryUnaryMultiCallable(_MultiCallable):
    async def __call__(self, request: Any, *, timeout: float | None = None,
                       metadata: Any = None, **_: Any) -> Any:
        call = self._call(timeout, metadata)
        await call.start()
        try:
            await call.send(request, end=True)
            return await _single_response(call)
        finally:
            if not call.ended:
                call.cancel()


class UnaryStreamMultiCallable(_MultiCallable):
    def __call__(self, request: Any, *, timeout: float | None = None,
                 metadata: Any = None, **_: Any) -> UnaryStreamCall:
        call = self._call(timeout, metadata)

        async def start() -> None:
            await call.start()
            await call.send(request, end=True)

        return UnaryStreamCall(call, start)


class StreamUnaryMultiCallable(_MultiCallable):
    async def __call__(self, requests: Any, *, timeout: float | None = None,
                       metadata: Any = None, **_: Any) -> Any:
        call = self._call(timeout, metadata)
        await call.start()
        call.send_all(requests)
        try:
            return await _single_response(call)
        finally:
            if not call.ended:
                call.cancel()


class StreamStreamMultiCallable(_MultiCallable):
    def __call__(self, requests: Any, *, timeout: float | None = None,
                 metadata: Any = None, **_: Any) -> UnaryStreamCall:
        call = self._call(timeout, metadata)

        async def start() -> None:
            await call.start()
            call.send_all(requests)

        return UnaryStreamCall(call, start)


class Channel:
    """An asyncio gRPC channel to ``host:port`` over one h2c connection at a
    time (a new one after the peer's GOAWAY or a loss), opened on first use
    on the loop that makes the call."""

    def __init__(self, target: str) -> None:
        self.target = target
        self.host, self.port = parse_target(target)
        self._conn: H2Connection | None = None
        self._lock: asyncio.Lock | None = None
        self._old: list[H2Connection] = []
        self._closed = False

    async def _connection(self) -> H2Connection:
        if self._closed:
            raise StreamReset(CANCEL, "channel closed")
        conn = self._conn
        if conn is not None and conn.usable:
            return conn
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            conn = self._conn
            if conn is not None and conn.usable:
                return conn
            if conn is not None:
                self._old = [c for c in self._old if not c.closed] + [conn]
            reader, writer = await asyncio.open_connection(self.host, self.port)
            conn = H2Connection(reader, writer, client=True)
            conn.start()
            self._conn = conn
            return conn

    def unary_unary(self, method: str, request_serializer: Callable | None = None,
                    response_deserializer: Callable | None = None,
                    **_: Any) -> UnaryUnaryMultiCallable:
        return UnaryUnaryMultiCallable(self, method, request_serializer, response_deserializer)

    def unary_stream(self, method: str, request_serializer: Callable | None = None,
                     response_deserializer: Callable | None = None,
                     **_: Any) -> UnaryStreamMultiCallable:
        return UnaryStreamMultiCallable(self, method, request_serializer, response_deserializer)

    def stream_unary(self, method: str, request_serializer: Callable | None = None,
                     response_deserializer: Callable | None = None,
                     **_: Any) -> StreamUnaryMultiCallable:
        return StreamUnaryMultiCallable(self, method, request_serializer, response_deserializer)

    def stream_stream(self, method: str, request_serializer: Callable | None = None,
                      response_deserializer: Callable | None = None,
                      **_: Any) -> StreamStreamMultiCallable:
        return StreamStreamMultiCallable(self, method, request_serializer, response_deserializer)

    async def close(self, grace: float | None = None) -> None:
        self._closed = True
        for conn in [*self._old, self._conn]:
            if conn is not None and not conn.closed:
                conn.close()
        self._conn = None
        self._old = []



class BlockingChannel:
    """A blocking gRPC channel (``grpc.insecure_channel``'s unary calls) for
    sync clients: the calls run on a loop thread of its own, which never
    waits for a caller, so a caller that blocks (a long-polling Pull) holds
    only its own thread."""

    def __init__(self, target: str) -> None:
        self.target = target
        parse_target(target)  # fail fast on a malformed target
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name=f"grpc-channel-{target}", daemon=True)
        self._thread.start()
        self._aio = Channel(target)
        self._closed = False

    def unary_unary(self, method: str, request_serializer: Callable | None = None,
                    response_deserializer: Callable | None = None, **_: Any) -> Callable:
        mc = self._aio.unary_unary(method, request_serializer, response_deserializer)

        def call(request: Any, timeout: float | None = None, metadata: Any = None) -> Any:
            if threading.current_thread() is self._thread:
                raise RuntimeError("a blocking gRPC call from its channel's own loop thread")
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "channel closed")
            if timeout is None:
                timeout = BLOCKING_DEFAULT_TIMEOUT_S
            fut = asyncio.run_coroutine_threadsafe(
                mc(request, timeout=timeout, metadata=metadata), self._loop)
            try:
                # the call ends itself at its deadline; the margin covers the hop
                return fut.result(timeout=timeout + 5.0)
            except TimeoutError:
                fut.cancel()
                raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None

        return call

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            asyncio.run_coroutine_threadsafe(self._aio.close(), self._loop).result(timeout=5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        if not self._thread.is_alive():
            self._loop.close()
