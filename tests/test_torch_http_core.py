"""The port's HTTP core against the JAX package's (``gofr_tpu/http``): the
router's patterns, path params, 404 and 405; request binding, params,
headers and body errors; the responder on every result kind and every error
class (status, JSON body, headers, ``Retry-After`` included); and the asyncio
server over a real socket (keep-alive, chunked streaming in and out,
malformed heads). Each case runs the same inputs through both packages and
holds the outputs equal, byte for byte on the wire."""

import asyncio
import dataclasses
import socket

import pytest

from gofr_tpu.http import dispatch as r_dispatch
from gofr_tpu.http import errors as r_errors
from gofr_tpu.http import request as r_request
from gofr_tpu.http import responder as r_responder
from gofr_tpu.http import response as r_response
from gofr_tpu.http import router as r_router
from gofr_tpu.http import server as r_server
from gofr_tpu_torch import errors as t_lifecycle_errors
from gofr_tpu_torch.http import dispatch as t_dispatch
from gofr_tpu_torch.http import errors as t_errors
from gofr_tpu_torch.http import request as t_request
from gofr_tpu_torch.http import responder as t_responder
from gofr_tpu_torch.http import response as t_response
from gofr_tpu_torch.http import router as t_router
from gofr_tpu_torch.http import server as t_server
from gofr_tpu_torch.testutil import get_free_port

PKGS = {
    "ref": dict(errors=r_errors, request=r_request, responder=r_responder, response=r_response,
                router=r_router, server=r_server, dispatch=r_dispatch),
    "port": dict(errors=t_errors, request=t_request, responder=t_responder, response=t_response,
                 router=t_router, server=t_server, dispatch=t_dispatch),
}


def both(fn):
    """``fn(pkg)`` on the reference and the port; the port's outcome, held
    equal to the reference's."""
    ref, port = fn(PKGS["ref"]), fn(PKGS["port"])
    assert port == ref
    return port


def test_one_error_hierarchy():
    """The lifecycle's error names are the HTTP errors' classes."""
    for name in ("ErrorTooManyRequests", "ErrorServiceUnavailable", "ErrorDeadlineExceeded",
                 "ErrorInvalidParam", "ErrorEntityNotFound", "ErrorStaleEpoch",
                 "ErrorRequestEntityTooLarge", "HTTPError"):
        assert getattr(t_lifecycle_errors, name) is getattr(t_errors, name)
    from gofr_tpu_torch.service.options import CircuitBreakerError

    assert t_lifecycle_errors.CircuitBreakerError is CircuitBreakerError


# ---------------------------------------------------------------- router
ROUTES = [("GET", "/user/{id}"), ("POST", "/user"), ("GET", "/files/{path...}"),
          ("PUT", "/user/{id}"), ("GET", "/"), ("DELETE", "/a/{b}/c/{d}")]
LOOKUPS = [("GET", "/user/42"), ("GET", "/user/42/"), ("GET", "/user"), ("POST", "/user"),
           ("DELETE", "/user/42"), ("GET", "/files/a/b/c.txt"), ("GET", "/"),
           ("DELETE", "/a/1/c/2"), ("GET", "/a/1/c/2"), ("GET", "/nope"), ("head", "/user/7")]


@pytest.mark.parametrize("method,path", LOOKUPS)
def test_router_lookup(method, path):
    def run(pkg):
        r = pkg["router"].Router()
        for i, (m, pattern) in enumerate(ROUTES):
            r.add(m, pattern, f"h{i}")
        return (r.lookup(method, path), r.path_exists(path), r.route_template(method, path),
                r.registered_methods(path), r.registered_methods())

    both(run)


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/user/1", 200), ("POST", "/user/1", 405), ("GET", "/missing", 404),
    ("HEAD", "/user/1", 200),
])
def test_dispatch_statuses(method, path, status):
    """404 for an unregistered route, 405 for a known path under another
    method, HEAD served by GET, through each package's dispatcher."""
    from gofr_tpu.container.container import Container as RContainer
    from gofr_tpu.config import MapConfig as RMap
    from gofr_tpu_torch.config import MapConfig as TMap
    from gofr_tpu_torch.container.container import Container as TContainer

    containers = {"ref": RContainer(RMap({"LOG_LEVEL": "FATAL"}, use_env=False)),
                  "port": TContainer(TMap({"LOG_LEVEL": "FATAL"}, use_env=False))}

    def run(pkg):
        name = "ref" if pkg is PKGS["ref"] else "port"
        r = pkg["router"].Router()
        r.add("GET", "/user/{id}", lambda ctx: {"id": ctx.path_param("id")})
        d = pkg["dispatch"].Dispatcher(r, containers[name])
        req = pkg["request"].Request(method, path, {}, {}, b"")
        resp = asyncio.run(d(req))
        return resp.status, resp.body

    assert both(run)[0] == status
    for c in containers.values():
        c.close()


# ---------------------------------------------------------------- binding
@dataclasses.dataclass
class UserIn:
    name: str = ""
    age: int = 0
    active: bool = False
    tags: list[str] = dataclasses.field(default_factory=list)


class Plain:
    name: str
    age: int


MULTIPART = (b"--XX\r\nContent-Disposition: form-data; name=\"name\"\r\n\r\nann\r\n"
             b"--XX\r\nContent-Disposition: form-data; name=\"age\"\r\n\r\n31\r\n"
             b"--XX\r\nContent-Disposition: form-data; name=\"f\"; filename=\"a.txt\"\r\n"
             b"Content-Type: text/plain\r\n\r\nhello\r\n--XX--\r\n")
BIND_CASES = [
    ("application/json", b'{"name": "ann", "age": 31, "extra": 1}', "user"),
    ("application/json", b'{"name": "ann", "age": 31}', "dict"),
    ("application/json", b'{"name": ', "user"),
    ("application/json", b"[1, 2]", "user"),
    ("application/json", b"", "dict"),
    (None, b'{"name": "bo"}', "user"),
    ("application/x-www-form-urlencoded", b"name=cy&age=7&active=true&tags=a,b", "user"),
    ("application/x-www-form-urlencoded", b"age=notanint", "user"),
    ("application/x-www-form-urlencoded", b"name=dee&age=4", "plain"),
    ("multipart/form-data; boundary=XX", MULTIPART, "dict"),
    ("text/plain", b"raw text", "str"),
    ("application/octet-stream", b"\x00\x01", "bytes"),
    ("application/octet-stream", b"\x00\x01", "user"),
    ("application/xml", b"<a/>", "dict"),
]


def _bound(value):
    if isinstance(value, (UserIn, Plain)):
        return type(value).__name__, dict(vars(value))
    if isinstance(value, dict):
        return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
                for k, v in value.items()}
    return value


@pytest.mark.parametrize("ctype,body,target", BIND_CASES)
def test_request_bind(ctype, body, target):
    def run(pkg):
        headers = {"Content-Type": ctype} if ctype else {}
        req = pkg["request"].Request("POST", "/x", {}, headers, body)
        tgt = {"user": UserIn, "dict": dict, "str": str, "bytes": bytes, "plain": Plain}[target]
        try:
            got = req.bind(tgt)
        except pkg["errors"].HTTPError as exc:
            return "error", type(exc).__name__, exc.status_code, str(exc)
        return "ok", _bound(got)

    both(run)


def test_request_params_and_headers():
    def run(pkg):
        req = pkg["request"].Request(
            "get", "/p", {"a": ["1", "2"], "b": ["x,y,,z"], "e": [""]},
            {"X-Forwarded-Proto": "https", "Host": "h:1", "X-Mixed-Case": "v"}, b"",
            path_params={"id": "9"})
        return (req.method, req.param("a"), req.params("a"), req.params("b"), req.param("e"),
                req.param("none"), req.path_param("id"), req.path_param("no"),
                req.header("x-mixed-case"), req.header("X-MIXED-CASE"), req.host_name(),
                req.content_type)

    both(run)


# ---------------------------------------------------------------- responder
def _errors(pkg):
    e = pkg["errors"]
    return [
        e.HTTPError(), e.ErrorInvalidRoute(), e.ErrorEntityNotFound("user", "9"),
        e.ErrorEntityAlreadyExist(), e.ErrorInvalidParam("a", "b"), e.ErrorMissingParam("id"),
        e.ErrorValidation("x too big", "y missing"), e.ErrorRequestTimeout(),
        e.ErrorClientClosedRequest(), e.ErrorPanicRecovery(),
        e.ErrorServiceUnavailable("draining", retry_after=2.2), e.ErrorServiceUnavailable(),
        e.ErrorTooManyRequests(retry_after=0.3456), e.ErrorTooManyRequests(),
        e.ErrorRequestEntityTooLarge(), e.ErrorStaleEpoch(), e.ErrorDeadlineExceeded(),
        RuntimeError("boom"), ValueError(""),
    ]


N_ERRORS = 19


@pytest.mark.parametrize("i", range(N_ERRORS))
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_responder_errors(i, method):
    def run(pkg):
        err = _errors(pkg)[i]
        w = pkg["responder"].Responder().respond(None, err, method)
        level = err.log_level().name if hasattr(err, "log_level") else None
        return w.status, w.headers, w.body, w.stream, level

    both(run)


RESULTS = ["dict", "none", "list", "dataclass", "envelope", "raw", "file", "redirect", "bytes",
           "partial"]


@pytest.mark.parametrize("kind", RESULTS)
@pytest.mark.parametrize("method", ["GET", "POST", "DELETE", "PUT"])
def test_responder_results(kind, method):
    def run(pkg):
        rt = pkg["response"]
        result, err = {
            "dict": ({"a": 1, "b": [1, 2]}, None),
            "none": (None, None),
            "list": ([1, "x", None], None),
            "dataclass": (UserIn("ann", 3), None),
            "envelope": (rt.Response(data={"k": "v"}, metadata={"page": 2},
                                     headers={"X-Custom": "1"}), None),
            "raw": (rt.Raw(data={"plain": True}), None),
            "file": (rt.File(content=b"\x89PNG", content_type="image/png"), None),
            "redirect": (rt.Redirect(url="/elsewhere"), None),
            "bytes": (b"abc", None),
            "partial": ({"some": 1}, pkg["errors"].ErrorPanicRecovery()),
        }[kind]
        w = pkg["responder"].Responder().respond(result, err, method)
        return w.status, w.headers, w.body

    both(run)


def test_responder_correlation_id_from_the_span():
    """The responder stamps ``X-Correlation-ID`` with the active span's trace
    id, each package from its own tracer."""
    from gofr_tpu.tracing import Tracer as RTracer
    from gofr_tpu_torch.tracing import Tracer as TTracer

    for pkg, tracer in ((PKGS["ref"], RTracer("t")), (PKGS["port"], TTracer("t"))):
        with tracer.start_span("s") as span:
            w = pkg["responder"].Responder().respond({"a": 1}, None, "GET")
        assert w.headers["X-Correlation-ID"] == span.trace_id


def test_status_from_error_table():
    def run(pkg):
        e = pkg["errors"]

        class WithStatus(Exception):
            status_code = 418

        class BadStatus(Exception):
            status_code = 999

        return [e.status_from_error(err, m, d) for err in (None, e.ErrorStaleEpoch(),
                                                           WithStatus(), BadStatus(), KeyError())
                for m in ("GET", "POST", "DELETE", "PATCH") for d in (False, True)]

    both(run)


# ---------------------------------------------------------------- server over a socket
async def _echo(req, pkg):
    rt = pkg["responder"].WireResponse
    if req.path == "/stream":
        async def gen():
            for piece in (b"one", b"", b"two", b"three"):
                yield piece
        return rt(headers={"Content-Type": "text/event-stream"}, stream=gen())
    if req.path == "/raise":
        raise RuntimeError("handler bug")
    body = f"{req.method} {req.path} {dict(sorted(req.query.items()))} {len(req.body)} " \
           f"{req.body[:16]!r}".encode()
    return rt(headers={"Content-Type": "text/plain"}, body=body)


RAW = {
    "keepalive": b"GET /a?x=1&x=2 HTTP/1.1\r\nHost: h\r\n\r\n"
                 b"POST /b HTTP/1.1\r\nContent-Length: 5\r\n\r\nhello"
                 b"GET /c HTTP/1.1\r\nConnection: close\r\n\r\n",
    "chunked_in": b"POST /up HTTP/1.1\r\nTransfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
                  b"4\r\nwiki\r\n5;ext=1\r\npedia\r\n0\r\n\r\n",
    "stream": b"GET /stream HTTP/1.1\r\nConnection: close\r\n\r\n",
    "head": b"HEAD /h HTTP/1.1\r\nConnection: close\r\n\r\n",
    "raise": b"GET /raise HTTP/1.1\r\nConnection: close\r\n\r\n",
    "bad_line": b"GARBAGE\r\n\r\n",
    "bad_version": b"GET / SPDY/3\r\n\r\n",
    "bad_header": b"GET / HTTP/1.1\r\nno-colon-here\r\n\r\n",
    "bad_length": b"POST / HTTP/1.1\r\nContent-Length: xyz\r\n\r\n",
    "bad_chunk": b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
    "quoted_path": b"GET /a%20b/c HTTP/1.1\r\nConnection: close\r\n\r\n",
    "folded_headers": b"GET /f HTTP/1.1\r\nX-A: 1\r\nX-A: 2\r\nConnection: close\r\n\r\n",
}


def _exchange(pkg, raw: bytes) -> bytes:
    async def main():
        port = get_free_port()
        server = pkg["server"].HTTPServer(lambda req: _echo(req, pkg), port, host="127.0.0.1")
        await server.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(raw)
            await writer.drain()
            data = await asyncio.wait_for(reader.read(), timeout=10)
            writer.close()
            return data
        finally:
            await server.shutdown()

    return asyncio.run(main())


@pytest.mark.parametrize("case", sorted(RAW))
def test_server_wire_bytes(case):
    """The same bytes in, the same bytes out (neither server writes a
    ``Date`` header)."""
    out = both(lambda pkg: _exchange(pkg, RAW[case]))
    assert out.startswith(b"HTTP/1.1 ")
    if case.startswith("bad_"):
        assert out.startswith(b"HTTP/1.1 400 ")
    if case == "keepalive":
        assert out.count(b"HTTP/1.1 200 OK") == 3
    if case == "stream":
        assert b"Transfer-Encoding: chunked" in out and out.endswith(b"0\r\n\r\n")


def test_server_client_drop_closes_the_stream():
    """A client that drops its socket mid-stream ends the response's
    generator (its ``finally`` runs): that is what frees a decode slot."""
    for pkg in PKGS.values():
        async def main():
            done = asyncio.Event()
            release = asyncio.Event()

            async def handler(req):
                async def gen():
                    try:
                        yield b"first"
                        await release.wait()
                        while True:
                            yield b"more"
                            await asyncio.sleep(0.005)
                    finally:
                        done.set()
                return pkg["responder"].WireResponse(stream=gen())

            port = get_free_port()
            server = pkg["server"].HTTPServer(handler, port, host="127.0.0.1")
            await server.start()
            try:
                sock = socket.create_connection(("127.0.0.1", port))
                sock.sendall(b"GET /s HTTP/1.1\r\n\r\n")
                await asyncio.sleep(0.05)
                sock.close()
                release.set()
                await asyncio.wait_for(done.wait(), timeout=10)
            finally:
                await server.shutdown()

        asyncio.run(main())
