"""The port's auth middleware (``gofr_tpu_torch/http/middleware/auth.py``,
``jwt.py``) beside the JAX package's: every provider and validator variant
(Basic over a user map, a function and a container function; API key over
a key list, a function and a container function; OAuth over an HS256
secret, and RS256 through a JWKS where ``cryptography`` imports) answers
the same accept and reject matrix over the same headers, methods and paths;
``jwt.decode`` agrees claim for claim on ``exp``, ``nbf``, issuer and
audience; ``ctx.get_auth_info()`` over real sockets; the JWKS fetch.

One row differs on purpose (ROADMAP Queue C 30): the reference lets every
method through on ``/.well-known/*``, so with auth on, an unauthenticated
``POST /.well-known/drain`` drains it; the port opens ``/.well-known/*``
to ``GET``/``HEAD``/``OPTIONS`` only and answers that POST with a 401."""

import asyncio
import base64
import http.server
import json
import threading
import time

import pytest

import gofr_tpu
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.http.middleware import auth as r_auth
from gofr_tpu.http.middleware import jwt as r_jwt
from gofr_tpu.http.request import Request as RRequest
from gofr_tpu.http.responder import WireResponse as RWire
from gofr_tpu_torch.app import App as TApp
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.http.middleware import auth as t_auth
from gofr_tpu_torch.http.middleware import jwt as t_jwt
from gofr_tpu_torch.http.request import Request as TRequest
from gofr_tpu_torch.http.responder import WireResponse as TWire
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app

SIDES = {"ref": (r_auth, RRequest, RWire), "port": (t_auth, TRequest, TWire)}
SECRET = "hs-secret"
CONTAINER = object()  # what the container validators receive
HAS_CRYPTO = t_jwt._HAS_CRYPTO and r_jwt._HAS_CRYPTO


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _hs(claims: dict, secret: str = SECRET, **headers) -> str:
    return t_jwt.encode_hs256(claims, secret, headers or None)


def _good_claims() -> dict:
    """Claims valid now: built at each use, as the tokens' times are
    relative to the clock (``exp`` 10 s past falls inside the 30 s leeway
    only while the test runs)."""
    now = time.time()
    return {"sub": "ada", "iss": "gofr", "aud": ["api", "web"], "exp": now + 600,
            "nbf": now - 60, "scope": "generate"}


def _headers() -> dict:
    """(name -> headers) sent to every provider."""
    now, good = time.time(), _good_claims()
    return {
        "none": {},
        "basic_good": {"Authorization": "Basic " + _b64("ada:pw")},
        "basic_wrong_password": {"Authorization": "Basic " + _b64("ada:nope")},
        "basic_unknown_user": {"Authorization": "Basic " + _b64("bob:pw")},
        "basic_no_colon": {"Authorization": "Basic " + _b64("adapw")},
        "basic_bad_base64": {"Authorization": "Basic !!!"},
        "basic_lowercase_scheme": {"Authorization": "basic " + _b64("ada:pw")},
        "apikey_good": {"X-API-Key": "k1"},
        "apikey_second": {"X-API-Key": "k2"},
        "apikey_wrong": {"X-API-Key": "k3"},
        "bearer_good": {"Authorization": "Bearer " + _hs(good)},
        "bearer_expired": {"Authorization": "Bearer " + _hs({**good, "exp": now - 600})},
        "bearer_not_yet": {"Authorization": "Bearer " + _hs({**good, "nbf": now + 600})},
        "bearer_in_leeway": {"Authorization": "Bearer " + _hs({**good, "exp": now - 10})},
        "bearer_wrong_issuer": {"Authorization": "Bearer " + _hs({**good, "iss": "other"})},
        "bearer_wrong_audience": {"Authorization": "Bearer " + _hs({**good, "aud": "other"})},
        "bearer_bad_signature": {"Authorization": "Bearer " + _hs(good, "another-secret")},
        "bearer_malformed": {"Authorization": "Bearer abc.def"},
        "bearer_alg_none": {"Authorization": "Bearer " + ".".join(
            base64.urlsafe_b64encode(json.dumps(p).encode()).rstrip(b"=").decode()
            for p in ({"alg": "none"}, good)) + "."},
    }

# (method, path): a private route, the probes, the admin drain, a preflight
TARGETS = [("GET", "/private"), ("POST", "/private"), ("GET", "/.well-known/health"),
           ("HEAD", "/.well-known/alive"), ("POST", "/.well-known/drain"),
           ("OPTIONS", "/private")]


def _providers(module):
    """Each provider variant of one package, built the same way."""
    return {
        "basic_users": lambda: module.basic_auth_middleware(users={"ada": "pw"}),
        "basic_func": lambda: module.basic_auth_middleware(
            validate_func=lambda u, p: (u, p) == ("ada", "pw")),
        "basic_container": lambda: module.basic_auth_middleware(
            validate_with_container=lambda c, u, p: c is CONTAINER and (u, p) == ("ada", "pw"),
            container=CONTAINER),
        "apikey_keys": lambda: module.api_key_auth_middleware(keys=["k1", "k2"]),
        "apikey_func": lambda: module.api_key_auth_middleware(validate_func=lambda k: k == "k1"),
        "apikey_container": lambda: module.api_key_auth_middleware(
            validate_with_container=lambda c, k: c is CONTAINER and k == "k2",
            container=CONTAINER),
        "oauth_hs256": lambda: module.oauth_middleware(hs_secret=SECRET, issuer="gofr",
                                                       audience="api"),
        "oauth_hs256_any_issuer": lambda: module.oauth_middleware(hs_secret=SECRET),
        "provider": lambda: module.auth_middleware(module.APIKeyAuthProvider(keys=["k2"])),
    }


def _ask(side: str, mw, method: str, path: str, headers: dict):
    """(status, body, headers) of one request through ``mw`` over a terminal
    handler that echoes what authenticated."""
    _, request_cls, wire = SIDES[side]

    async def terminal(req):
        info = getattr(req, "auth", None)
        seen = None if info is None else {"method": info.method, "user": info.username,
                                          "key": info.api_key, "claims": info.claims}
        return wire(status=200, body=json.dumps({"auth": seen}).encode())

    req = request_cls(method, path, {}, headers, b"")
    resp = asyncio.run(mw(terminal)(req))
    return resp.status, json.loads(resp.body), dict(resp.headers)


@pytest.mark.parametrize("provider", list(_providers(t_auth)))
def test_accept_and_reject_matrix_equals_the_reference(provider):
    """Every header set on every target: the same status, body and headers
    from both packages, except a POST under ``/.well-known/`` (Queue C 30),
    which the reference passes unauthenticated and the port authenticates
    as it does a private route."""
    mws = {side: _providers(module)[provider]() for side, (module, _, _) in SIDES.items()}
    accepted = 0
    for name, headers in _headers().items():
        for method, path in TARGETS:
            got = {side: _ask(side, mw, method, path, headers) for side, mw in mws.items()}
            if method == "POST" and path.startswith("/.well-known/"):
                # the reference skips auth there; the port authenticates as
                # on any private route
                assert got["ref"][:2] == (200, {"auth": None}), (name, method, path)
                assert got["port"] == _ask("port", mws["port"], "POST", "/private", headers)
                continue
            assert got["port"] == got["ref"], (provider, name, method, path)
            accepted += got["port"][1].get("auth") is not None
    assert accepted > 0  # each variant accepts something


def test_provider_outcomes():
    """Which header sets each variant accepts on a private route (the
    matrix above holds the port to the reference; this holds both to the
    rules)."""
    want = {
        "basic_users": {"basic_good", "basic_lowercase_scheme"},
        "basic_func": {"basic_good", "basic_lowercase_scheme"},
        "basic_container": {"basic_good", "basic_lowercase_scheme"},
        "apikey_keys": {"apikey_good", "apikey_second"},
        "apikey_func": {"apikey_good"},
        "apikey_container": {"apikey_second"},
        "oauth_hs256": {"bearer_good", "bearer_in_leeway"},
        "oauth_hs256_any_issuer": {"bearer_good", "bearer_in_leeway", "bearer_wrong_issuer",
                                   "bearer_wrong_audience"},
        "provider": {"apikey_second"},
    }
    for provider, factory in _providers(t_auth).items():
        mw = factory()
        got = {name for name, headers in _headers().items()
               if _ask("port", mw, "GET", "/private", headers)[0] == 200}
        assert got == want[provider], provider


def _tokens() -> dict:
    """(name -> (claims, decode keywords)), times relative to now."""
    now, good = time.time(), _good_claims()
    return {
        "good": (good, {}),
        "no_exp": ({"sub": "ada"}, {}),
        "expired": ({**good, "exp": now - 600}, {}),
        "leeway": ({**good, "exp": now - 10}, {}),
        "nbf_future": ({**good, "nbf": now + 600}, {}),
        "issuer": ({**good, "iss": "x"}, {"issuer": "gofr"}),
        "issuer_ok": (good, {"issuer": "gofr"}),
        "audience_str": ({**good, "aud": "api"}, {"audience": "api"}),
        "audience_list": (good, {"audience": "web"}),
        "audience_missing": ({"sub": "ada"}, {"audience": "api"}),
        "no_secret": (good, {"hs_secret": None}),
    }


@pytest.mark.parametrize("case", list(_tokens()))
def test_jwt_decode_equals_the_reference(case):
    """The same claims, or a ``JWTError`` with the same message, from both
    packages' ``decode``."""
    claims, kw = _tokens()[case]
    kw = {"hs_secret": SECRET, **kw}
    token = _hs(claims)
    got = {}
    for side, module in (("ref", r_jwt), ("port", t_jwt)):
        try:
            got[side] = ("ok", module.decode(token, **kw))
        except module.JWTError as exc:
            got[side] = ("error", str(exc))
    assert got["port"] == got["ref"]
    assert (got["port"][0] == "ok") == (case in ("good", "no_exp", "leeway", "issuer_ok",
                                                 "audience_str", "audience_list"))


def test_hs256_tokens_equal_the_reference():
    for claims in (_good_claims(), {"sub": "x"}, {}):
        assert t_jwt.encode_hs256(claims, SECRET, {"kid": "a"}) == \
            r_jwt.encode_hs256(claims, SECRET, {"kid": "a"})


@pytest.fixture(scope="module")
def rsa_key():
    if not HAS_CRYPTO:
        pytest.skip("RS256 needs the cryptography package")
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _rs256(key, claims: dict, kid: str = "k1") -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    enc = t_jwt._b64url_encode
    head = enc(json.dumps({"alg": "RS256", "typ": "JWT", "kid": kid}).encode())
    body = enc(json.dumps(claims).encode())
    sig = key.sign(f"{head}.{body}".encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{head}.{body}.{enc(sig)}"


def _jwk(key, kid: str = "k1") -> dict:
    nums = key.public_key().public_numbers()
    enc = t_jwt._b64url_encode
    return {"kty": "RSA", "kid": kid, "n": enc(nums.n.to_bytes((nums.n.bit_length() + 7) // 8, "big")),
            "e": enc(nums.e.to_bytes(3, "big"))}


def test_rs256_over_a_jwks_equals_the_reference(rsa_key):
    """A JWKS served over HTTP, fetched by each package's ``JWKSProvider``:
    a token signed by its key is accepted with the same claims, one signed
    by another key or naming an unknown kid the same way, on both."""
    from cryptography.hazmat.primitives.asymmetric import rsa

    other = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    jwks = json.dumps({"keys": [_jwk(rsa_key), {"kty": "EC", "kid": "skip"}]}).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(jwks)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/jwks"
    try:
        providers = {"ref": r_jwt.JWKSProvider(url), "port": t_jwt.JWKSProvider(url)}
        assert set(providers["port"].keys()) == set(providers["ref"].keys()) == {"k1"}
        good = _good_claims()
        tokens = {"good": _rs256(rsa_key, good), "other_key": _rs256(other, good),
                  "unknown_kid": _rs256(rsa_key, good, kid="k9"),
                  "expired": _rs256(rsa_key, {**good, "exp": time.time() - 600})}
        for name, token in tokens.items():
            got = {}
            for side, module in (("ref", r_jwt), ("port", t_jwt)):
                try:
                    got[side] = module.decode(token, rsa_keys=providers[side].keys())
                except module.JWTError as exc:
                    got[side] = str(exc)
            assert got["port"] == got["ref"], name
            assert isinstance(got["port"], dict) == (name in ("good", "unknown_kid")), name
        for side, module in (("ref", r_auth), ("port", t_auth)):
            mw = module.oauth_middleware(jwks_provider=providers[side], audience="api")
            status, body, _ = _ask(side, mw, "GET", "/private",
                                   {"Authorization": "Bearer " + tokens["good"]})
            assert status == 200 and body["auth"]["user"] == "ada"
        for p in providers.values():
            p.close()
    finally:
        server.shutdown()


def test_rs256_without_cryptography_raises_cleanly(monkeypatch):
    """Where ``cryptography`` does not import, an RS256 token is a
    ``JWTError`` (a 401 through the middleware), never an ImportError."""
    monkeypatch.setattr(t_jwt, "_HAS_CRYPTO", False)
    token = ".".join(t_jwt._b64url_encode(json.dumps(p).encode())
                     for p in ({"alg": "RS256", "kid": "k"}, _good_claims())) + ".c2ln"
    with pytest.raises(t_jwt.JWTError, match="cryptography"):
        t_jwt.decode(token, rsa_keys={"k": object()})
    with pytest.raises(t_jwt.JWTError, match="cryptography"):
        t_jwt.jwk_to_rsa_key({"n": "AQAB", "e": "AQAB"})
    mw = t_auth.oauth_middleware(jwks_provider=type("P", (), {"keys": lambda self: {"k": 1}})())
    assert _ask("port", mw, "GET", "/private", {"Authorization": "Bearer " + token})[0] == 401


def _serve(side: str, enable):
    app_cls, config = (gofr_tpu.App, RMapConfig) if side == "ref" else (TApp, TMapConfig)
    app = app_cls(config({"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
                          "HTTP_HOST": "127.0.0.1", "APP_NAME": f"auth-{side}",
                          "LOG_LEVEL": "FATAL", "SHUTDOWN_GRACE_PERIOD": "5"}, use_env=False))
    enable(app, SIDES[side][0])

    def whoami(ctx):
        info = ctx.get_auth_info()
        return {"method": info.method, "user": info.get_username(), "key": info.get_apikey(),
                "sub": info.get_claims().get("sub")}

    app.get("/whoami", whoami)
    return app


# (enable(app, that package's auth module), the headers that authenticate)
ENABLES = {
    "basic": (lambda app, m: app.enable_basic_auth({"ada": "pw"}),
              {"Authorization": "Basic " + _b64("ada:pw")}),
    "basic_validator": (lambda app, m: app.enable_basic_auth_with_validator(
        lambda c, u, p: c is app.container and p == "pw"),
        {"Authorization": "Basic " + _b64("ada:pw")}),
    "apikey": (lambda app, m: app.enable_api_key_auth("k1", "k2"), {"X-API-Key": "k2"}),
    "apikey_validator": (lambda app, m: app.enable_api_key_auth_with_validator(
        lambda c, k: c is app.container and k == "k1"), {"X-API-Key": "k1"}),
    "provider": (lambda app, m: app.enable_auth_provider(m.OAuthProvider(hs_secret=SECRET)),
                 None),  # a bearer token made when the test runs
}


@pytest.mark.parametrize("how", list(ENABLES))
def test_ctx_auth_over_the_wire_equals_the_reference(how):
    """``App.enable_*``: a request without credentials is a 401 and the
    probe answers; with them the handler's ``ctx.get_auth_info()`` reads the
    same on both apps."""
    enable, headers = ENABLES[how]
    headers = headers or {"Authorization": "Bearer " + _hs(_good_claims())}
    got = {}
    for side in ("ref", "port"):
        app = _serve(side, enable)
        thread = start_app(app)
        base = f"http://127.0.0.1:{app.http_port}"
        try:
            got[side] = (fetch(base + "/whoami")[0], fetch(base + "/.well-known/health")[0],
                         json.loads(fetch(base + "/whoami", headers=headers)[2]))
        finally:
            stop_app(app, thread)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (401, 200) and got["port"][2]["data"]["user"] in ("ada", "")


def test_admin_drain_behind_auth_queue_c_30():
    """Queue C 30: with ``enable_api_key_auth`` and ``register_admin_drain``
    at its default path, an unauthenticated ``POST /.well-known/drain``
    drains the reference app (its auth skips ``/.well-known/*``); the port
    answers it 401 and keeps serving, and drains with the key."""
    from gofr_tpu.serving.handlers import register_admin_drain as r_drain
    from gofr_tpu_torch.serving.handlers import register_admin_drain as t_drain

    post = {"Content-Type": "application/json"}
    ref = _serve("ref", lambda app, m: app.enable_api_key_auth("k1"))
    r_drain(ref)
    thread = start_app(ref)
    status = fetch(f"http://127.0.0.1:{ref.http_port}/.well-known/drain", "POST", b"{}", post)[0]
    thread.join(timeout=30)
    assert status == 201 and ref.container.draining and not thread.is_alive()

    port = _serve("port", lambda app, m: app.enable_api_key_auth("k1"))
    t_drain(port)
    thread = start_app(port)
    base = f"http://127.0.0.1:{port.http_port}"
    try:
        assert fetch(base + "/.well-known/drain", "POST", b"{}", post)[0] == 401
        assert not port.container.draining and thread.is_alive()
        assert fetch(base + "/.well-known/health")[0] == 200
        assert fetch(base + "/.well-known/drain", "POST", b"{}", {**post, "X-API-Key": "k1"})[0] \
            == 201
        thread.join(timeout=30)
        assert port.container.draining and not thread.is_alive()
    finally:
        if thread.is_alive():
            stop_app(port, thread)
