"""Asyncio HTTP/1.1 server (a copy of ``gofr_tpu/http/server.py`` without the
WebSocket upgrade hook, which is not ported).

The reference rides Go's net/http (http_server.go:17-121); Python's stdlib has
no production-grade async server, so this build ships its own: HTTP/1.1
parsing, keep-alive, Content-Length and chunked bodies, chunked/SSE streaming
responses (the token-decode path), optional TLS (CERT_FILE/KEY_FILE,
factory.go:43-44). One connection = one asyncio
task — the analogue of net/http's goroutine-per-connection.

Streaming: a WireResponse with ``stream`` set to an async iterator of bytes
is sent with ``Transfer-Encoding: chunked``, flushed per chunk — this is how
token-by-token decode reaches HTTP clients (SURVEY §7 phase 4).
"""

from __future__ import annotations

import asyncio
import ssl
import urllib.parse
from typing import Any, Awaitable, Callable

from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import WireResponse

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 256 << 20  # generous: model uploads go through file APIs

STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    206: "Partial Content", 301: "Moved Permanently", 302: "Found",
    304: "Not Modified", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 409: "Conflict", 413: "Payload Too Large",
    429: "Too Many Requests", 499: "Client Closed Request",
    500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway", 503: "Service Unavailable", 504: "Gateway Timeout",
}


class BadRequest(Exception):
    pass


async def _read_request(reader: asyncio.StreamReader) -> Request | None:
    """Parse one HTTP/1.1 request; None on clean EOF."""
    try:
        header_blob = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as exc:
        if not exc.partial:
            return None
        raise BadRequest("truncated request") from exc
    except asyncio.LimitOverrunError as exc:
        raise BadRequest("headers too large") from exc
    if len(header_blob) > MAX_HEADER_BYTES:
        raise BadRequest("headers too large")

    lines = header_blob.decode("latin-1").split("\r\n")
    request_line = lines[0]
    parts = request_line.split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1"):
        raise BadRequest(f"malformed request line: {request_line!r}")
    method, target, _version = parts
    parsed = urllib.parse.urlsplit(target)
    path = urllib.parse.unquote(parsed.path) or "/"
    query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)

    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        if ":" not in line:
            raise BadRequest(f"malformed header: {line!r}")
        key, _, value = line.partition(":")
        key = key.strip().lower()
        value = value.strip()
        if key in headers:
            headers[key] += ", " + value
        else:
            headers[key] = value

    body = b""
    if "content-length" in headers:
        try:
            length = int(headers["content-length"])
        except ValueError as exc:
            raise BadRequest("bad Content-Length") from exc
        if length > MAX_BODY_BYTES:
            raise BadRequest("body too large")
        if length:
            body = await reader.readexactly(length)
    elif headers.get("transfer-encoding", "").lower() == "chunked":
        chunks: list[bytes] = []
        total = 0
        while True:
            size_line = (await reader.readuntil(b"\r\n")).strip()
            try:
                size = int(size_line.split(b";")[0], 16)
            except ValueError as exc:
                raise BadRequest("bad chunk size") from exc
            if size == 0:
                await reader.readuntil(b"\r\n")
                break
            total += size
            if total > MAX_BODY_BYTES:
                raise BadRequest("body too large")
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # trailing CRLF
        body = b"".join(chunks)

    return Request(method, path, query, headers, body)


def _serialize_head(resp: WireResponse, *, chunked: bool, keep_alive: bool) -> bytes:
    text = STATUS_TEXT.get(resp.status, "Unknown")
    out = [f"HTTP/1.1 {resp.status} {text}"]
    headers = dict(resp.headers)
    if chunked:
        headers["Transfer-Encoding"] = "chunked"
        headers.pop("Content-Length", None)
    else:
        headers.setdefault("Content-Length", str(len(resp.body)))
    headers.setdefault("Connection", "keep-alive" if keep_alive else "close")
    for k, v in headers.items():
        out.append(f"{k}: {v}")
    return ("\r\n".join(out) + "\r\n\r\n").encode("latin-1")


class HTTPServer:
    def __init__(
        self,
        handler: Callable[[Request], Awaitable[WireResponse]],
        port: int,
        host: str = "0.0.0.0",
        logger: Any = None,
        cert_file: str | None = None,
        key_file: str | None = None,
    ) -> None:
        self.handler = handler
        self.host = host
        self.port = port
        self.logger = logger
        self.cert_file = cert_file
        self.key_file = key_file
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        ssl_ctx = None
        if self.cert_file and self.key_file:
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(self.cert_file, self.key_file)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
            ssl=ssl_ctx, limit=MAX_HEADER_BYTES,
        )
        if self.logger:
            scheme = "https" if ssl_ctx else "http"
            self.logger.info(f"{scheme} server listening on :{self.port}")

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        remote = f"{peer[0]}" if peer else ""
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except BadRequest as exc:
                    await self._write_simple(writer, 400, str(exc))
                    break
                if req is None:
                    break
                req.remote_addr = remote
                keep_alive = req.headers.get("connection", "").lower() != "close"
                try:
                    resp = await self.handler(req)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # last-resort isolation
                    if self.logger:
                        self.logger.error(f"unhandled server error: {exc}")
                    resp = WireResponse(status=500, body=b'{"error":{"message":"internal error"}}',
                                        headers={"Content-Type": "application/json"})

                if resp.stream is not None:
                    writer.write(_serialize_head(resp, chunked=True, keep_alive=keep_alive))
                    await writer.drain()
                    # aclose() runs on EVERY exit (disconnect, abort, timeout,
                    # cancellation) so the generator's finally-blocks fire —
                    # that's what frees the batched-decode slot. aclose on an
                    # exhausted generator is a no-op.
                    try:
                        async for chunk in resp.stream:
                            if not chunk:
                                continue
                            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                            await writer.drain()
                    finally:
                        aclose = getattr(resp.stream, "aclose", None)
                        if aclose is not None:
                            try:
                                await aclose()
                            except Exception:
                                pass
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                else:
                    head = _serialize_head(resp, chunked=False, keep_alive=keep_alive)
                    body = b"" if req.method == "HEAD" else resp.body
                    writer.write(head + body)
                    await writer.drain()
                if not keep_alive:
                    break
        except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass  # client aborted/timed out; writer closed in finally
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _write_simple(self, writer: asyncio.StreamWriter, status: int, message: str) -> None:
        resp = WireResponse(status=status, body=message.encode(), headers={"Content-Type": "text/plain"})
        writer.write(_serialize_head(resp, chunked=False, keep_alive=False))
        writer.write(resp.body)
        try:
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
