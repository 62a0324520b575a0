"""The remote token-stream client and ``HTTPReplica`` against the JAX
package's (``gofr_tpu/serving/remote.py``, ``gofr_tpu/serving/router.py``):
``iter_events`` on byte fixtures, ``error_from_status`` across statuses (a
remote 503 and 429 land in the port router's ``RETRIABLE_ERRORS``),
``run_stream`` over scripted responses; then over real sockets, two tiny
engines behind two apps on each side: ``HTTPReplica`` submit (streamed and
unary), a cancel that lands before the id frame, ``fetch_kv`` and the
breaker's callback; and a router over two ``HTTPReplica``s that fails over
when one app stops, with the same outcome as the reference router over
reference apps."""

import io
import random
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gofr_tpu  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.datasource.pubsub.memory import InMemoryBroker as RBroker  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import handlers as r_handlers  # noqa: E402
from gofr_tpu.serving import membership as r_ms  # noqa: E402
from gofr_tpu.serving import prefix_index as r_pi  # noqa: E402
from gofr_tpu.serving import remote as r_remote  # noqa: E402
from gofr_tpu.serving import router as r_router  # noqa: E402
from gofr_tpu_torch import chaos as t_chaos  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.pubsub import InMemoryBroker as TBroker  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving import membership as t_ms  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as t_pi  # noqa: E402
from gofr_tpu_torch.serving import remote as t_remote  # noqa: E402
from gofr_tpu_torch.serving import router as t_router  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import get_free_port, start_app, stop_app  # noqa: E402

REMOTE = {"ref": r_remote, "port": t_remote}
ROUTER = {"ref": r_router, "port": t_router}
TIMEOUT = 120


class Lines:
    """A streaming response over fixed bytes: the ``lines()`` surface
    ``iter_events`` reads, plus the rest of ``StreamingServiceResponse``."""

    def __init__(self, raw: bytes, status: int = 200, headers=None):
        self._raw = io.BytesIO(raw)
        self.status_code = status
        self.headers = headers or {}
        self.closed = False

    @property
    def ok(self):
        return 200 <= self.status_code < 300

    def lines(self):
        for line in self._raw:
            yield line.decode("utf-8", "replace").rstrip("\r\n")

    def read_body(self):
        return self._raw.read()

    def close(self):
        self.closed = True


FIXTURES = {
    "plain": b'id: 0\ndata: {"id": 4}\n\nid: 1\ndata: {"token": 7, "text": "a"}\n\n'
             b'id: 2\ndata: {"finish_reason": "length", "usage": {"completion_tokens": 1}}\n\n'
             b"data: [DONE]\n\n",
    "noise": b": keepalive\n\nevent: x\ndata: not json\n\ndata: [1, 2]\n\nid: bad\n"
             b'data: {"token": 1, "text": ""}\n\ndata: {"token": 2}\n\n',
    "error": b'id: 0\ndata: {"id": 1}\n\ndata: {"error": "drain deadline", "status": 503}\n\n'
             b"data: [DONE]\n\n",
    "late_504": b'data: {"id": 1}\n\ndata: {"error": "expired", "status": 504}\n\n',
    "torn": b'id: 0\ndata: {"id": 3}\n\nid: 1\ndata: {"token": 5, "text": "x"}\n\n',
    "after_done": b'data: {"id": 1}\n\ndata: [DONE]\n\ndata: {"token": 9}\n\n',
    "crlf": b'id: 0\r\ndata: {"id": 8}\r\n\r\ndata: {"finish_reason": "stop"}\r\n\r\n',
    "empty": b"",
}


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as exc:
        return "raise", type(exc).__name__, str(exc), getattr(exc, "status_code", None)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_iter_events(name):
    got = {side: _outcome(lambda m=m: list(m.iter_events(Lines(FIXTURES[name]))))
           for side, m in REMOTE.items()}
    assert got["port"] == got["ref"]


def test_iter_events_whole_stream_deadline():
    got = {side: _outcome(lambda m=m: list(m.iter_events(Lines(FIXTURES["plain"]),
                                                         deadline_abs=time.monotonic() - 1)))
           for side, m in REMOTE.items()}
    assert got["port"] == got["ref"]
    assert got["port"][1] == "ErrorDeadlineExceeded"


def test_stream_remote_chaos_point_tears_the_stream():
    """A ``stream.remote`` fault is the transport dying between frames."""
    inj = t_chaos.ChaosInjector(0, {"stream.remote": 1.0}, max_faults=1)
    with t_chaos.active(inj):
        with pytest.raises(t_chaos.ChaosFault):
            list(t_remote.iter_events(Lines(FIXTURES["plain"])))


STATUSES = [(503, {"Retry-After": "2"}), (503, {}), (429, {"retry-after": "0.5"}), (429, {}),
            (504, {}), (409, {}), (404, {}), (500, {}), (400, {}), (0, {}),
            (503, {"Retry-After": "Wed, 21 Oct 2015 07:28:00 GMT"})]


@pytest.mark.parametrize("status,headers", STATUSES)
def test_error_from_status(status, headers):
    got = {}
    for side, m in REMOTE.items():
        exc = m.error_from_status(status, f"remote HTTP {status}", headers)
        retriable = isinstance(exc, ROUTER[side].RETRIABLE_ERRORS)
        got[side] = (type(exc).__name__, str(exc), getattr(exc, "status_code", None),
                     getattr(exc, "retry_after", None), retriable)
    assert got["port"] == got["ref"]
    if status in (503, 429):
        assert got["port"][4], "a remote 503/429 must stay retriable"


class FakeSvc:
    def __init__(self, resp):
        self.resp = resp
        self.calls = []

    def stream(self, method, path, **kw):
        self.calls.append((method, path, kw.get("json"), kw.get("headers")))
        return self.resp


SCRIPTS = [("plain", 200, {}), ("error", 200, {}), ("torn", 200, {}), ("late_504", 200, {}),
           ("empty", 503, {"Retry-After": "1"}), ("empty", 429, {}), ("empty", 404, {})]


@pytest.mark.parametrize("fixture,status,headers", SCRIPTS)
def test_run_stream_and_resume(fixture, status, headers):
    got = {}
    for side, m in REMOTE.items():
        seen = []
        svc = FakeSvc(Lines(FIXTURES[fixture], status, headers))
        run = _outcome(lambda: m.run_stream(svc, {"prompt": "p"}, headers={"X": "1"},
                                            on_id=lambda i: seen.append(("id", i)),
                                            on_token=lambda t, s: seen.append(("tok", t, s))))
        frames = []
        svc2 = FakeSvc(Lines(FIXTURES[fixture], status, headers))
        res = _outcome(lambda: m.resume_stream(svc2, "key", last_seq=3, fence_epoch=2,
                                               on_frame=lambda *a: frames.append(a)))
        got[side] = (run, seen, svc.calls, svc.resp.closed, res, frames, svc2.calls)
    assert got["port"] == got["ref"]


# ------------------------------------------------------------- real sockets
BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
            prefill_chunk_tokens=16, prefix_cache_entries=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fleet():
    """Per side: a broker and two started apps "a" and "b", each over a tiny
    engine announced on the broker."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    out = {}
    for side in ("ref", "port"):
        broker = (RBroker if side == "ref" else TBroker)(consumer_group="router",
                                                         poll_timeout=0.02)
        nodes = {}
        for rid in ("a", "b"):
            values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
                      "HTTP_HOST": "127.0.0.1", "APP_NAME": f"{side}-{rid}",
                      "LOG_LEVEL": "FATAL", "SHUTDOWN_GRACE_PERIOD": "5"}
            if side == "ref":
                app = gofr_tpu.App(RMapConfig(values, use_env=False))
                engine = JServingEngine(jcfg, jparams, JEngineConfig(**BASE), JByteTokenizer())
                r_handlers.register_generation_routes(app, engine)
                ann = r_ms.ReplicaAnnouncer(rid, engine, broker, interval_s=0.05)
            else:
                app = TApp(TMapConfig(values, use_env=False))
                engine = ServingEngine(tcfg, tparams, EngineConfig(**BASE), ByteTokenizer(),
                                       device="cpu")
                t_handlers.register_generation_routes(app, engine)
                ann = t_ms.ReplicaAnnouncer(rid, engine, broker, interval_s=0.05)
            thread = start_app(app)
            ann.start()
            nodes[rid] = dict(app=app, engine=engine, thread=thread, ann=ann,
                              url=f"http://127.0.0.1:{app.http_port}")
        out[side] = dict(broker=broker, nodes=nodes)
    yield {**out, "_models": dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams)}
    for side in out.values():
        for node in side["nodes"].values():
            node["ann"].stop(final_beat=False)
            if node["thread"].is_alive():
                stop_app(node["app"], node["thread"])


def _sides(fleet):
    return [(side, fleet[side]) for side in ("ref", "port")]


def _frames():
    got = []
    return got, lambda tok, piece, done: got.append((tok, piece, done))


def test_http_replica_submit_cancel_fetch(fleet):
    got = {}
    for side, f in _sides(fleet):
        node = f["nodes"]["a"]
        rep = ROUTER[side].HTTPReplica("a", node["url"])
        try:
            frames, cb = _frames()
            res = rep.submit("remote tokens", max_new_tokens=5, temperature=0.0,
                             stream_cb=cb).result(timeout=TIMEOUT)
            local = node["engine"].submit("remote tokens", max_new_tokens=5,
                                          temperature=0.0).result(timeout=TIMEOUT)
            assert res.token_ids == list(local.token_ids)
            assert [t for t, _, d in frames if not d] == list(local.token_ids)
            assert frames[-1][2] is True
            unary = rep.submit("remote tokens", max_new_tokens=5).result(timeout=TIMEOUT)
            # cancel before the id frame can have landed: it parks, then fires
            frames2, cb2 = _frames()
            fut = rep.submit("cancel early " * 3, max_new_tokens=100, stream_cb=cb2)
            rep.cancel(fut.request_id)
            early = fut.result(timeout=TIMEOUT)
            # the whole-prompt entry of "remote tokens" (how far the canceled
            # request got before its cancel landed differs run to run)
            keys = sorted(k for k, _ in node["engine"].prefix_advertisement()
                          if k.startswith("prefill:"))
            fetched = rep.fetch_kv(keys[:3] + ["absent"])
            shapes = {k: [tuple(x.shape) for x in v] for k, v in fetched.items()}
            health = rep.health_check()
            assert health["details"].pop("host") == node["url"]
        finally:
            rep.close()
        got[side] = (res.token_ids, res.finish_reason, res.completion_tokens, unary.text,
                     unary.finish_reason, early.finish_reason, len(early.token_ids) < 100,
                     sorted(shapes) == sorted(keys[:3]), shapes, health)
    assert got["port"] == got["ref"]
    assert got["port"][5] == "cancel"


def test_migration_over_the_wire(fleet):
    """A third engine whose ``KVMigrator`` holds ``HTTPReplica("a").fetch_kv``
    admits a prompt app a served from a's entries over ``/kv/fetch``: a's
    tokens, the remote tier, no prefill compute; the same on both sides."""
    got = {}
    for side, f in _sides(fleet):
        node = f["nodes"]["a"]
        pi = r_pi if side == "ref" else t_pi
        index = pi.PrefixIndex()
        migrator = pi.KVMigrator("c", index)
        rep = ROUTER[side].HTTPReplica("a", node["url"])
        migrator.add_peer("a", rep.fetch_kv)
        if side == "ref":
            c = JServingEngine(fleet["_models"]["jcfg"], fleet["_models"]["jparams"],
                               JEngineConfig(**BASE), JByteTokenizer(), kv_migrator=migrator)
        else:
            c = ServingEngine(fleet["_models"]["tcfg"], fleet["_models"]["tparams"],
                              EngineConfig(**BASE), ByteTokenizer(), device="cpu",
                              kv_migrator=migrator)
        c.start()
        try:
            prompt = "wire transfer prefix " * 3
            want = node["engine"].submit(prompt, max_new_tokens=4,
                                         temperature=0.0).result(timeout=TIMEOUT)
            index.observe("a", 1, node["engine"].prefix_advertisement())
            r = c.submit(prompt, max_new_tokens=4, temperature=0.0).result(timeout=TIMEOUT)
            got[side] = (list(r.token_ids) == list(want.token_ids),
                         c.timeline.get(r.request_id).prefix_tier, migrator.migrations_total)
        finally:
            c.stop()
            rep.close()
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (True, "remote") and got["port"][2] >= 1


def test_a_slow_kv_fetch_is_a_compute_miss_on_both_sides():
    """ROADMAP Queue C 27: at Llama-3-8B one 1000-token entry is ~180 MB of
    base64 JSON and its fetch takes seconds, past both packages' default
    fetch timeout of 2 s. A peer slower than the timeout makes the fetch
    raise, which the migrator turns into a compute miss, on both sides."""
    import http.server
    import threading

    class Slow(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            time.sleep(1.0)
            body = b'{"data": {"entries": {}}}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    class Quiet(http.server.ThreadingHTTPServer):
        def handle_error(self, request, client_address):
            pass  # the client left at its timeout: the late write fails

    srv = Quiet(("127.0.0.1", get_free_port()), Slow)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    got = {}
    try:
        for side, pi in (("ref", r_pi), ("port", t_pi)):
            rep = ROUTER[side].HTTPReplica("slow", f"http://127.0.0.1:{srv.server_port}")
            index = pi.PrefixIndex()
            index.observe("slow", 1, [["k", "device"]])
            migrator = pi.KVMigrator("c", index, fetch_timeout_s=0.2)
            migrator.add_peer("slow", rep.fetch_kv)
            t0 = time.monotonic()
            value = migrator.fetch_one("k")  # the transport times out: a miss
            got[side] = (pi.KVMigrator("d", pi.PrefixIndex()).fetch_timeout_s, value,
                         migrator.failed_fetches_total, time.monotonic() - t0 < 0.9)
            rep.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["port"] == got["ref"] == (2.0, None, 1, True)


def test_breaker_callback_marks_the_replica(fleet):
    """Transport failures to a dead address open the breaker, whose
    callback names the replica; each failure is retriable."""
    got = {}
    for side, _ in _sides(fleet):
        opened = []
        rep = ROUTER[side].HTTPReplica("dead", f"http://127.0.0.1:{get_free_port()}",
                                       breaker_threshold=2, breaker_interval=60.0,
                                       on_breaker_open=opened.append)
        errs = []
        for _ in range(3):
            exc = rep.submit("x", deadline=2.0, stream_cb=lambda *a: None).exception(
                timeout=TIMEOUT)
            errs.append((type(exc).__name__, isinstance(exc, ROUTER[side].RETRIABLE_ERRORS)))
        rep.close()
        got[side] = (opened, errs)
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["dead"]


def _affine_prompts(router, rid, n, seed):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        p = "".join(rng.choice("abcdefghij ") for _ in range(24))
        if router._candidates_for(p)[0][:1] == [rid]:
            out.append(p)
    return out


def _wait_beats_settled(router, rid, period_s, timeout_s=10.0):
    """Wait until the router has consumed the last beat of a stopped
    announcer: ``rid``'s beat sequence unchanged over two heartbeat periods.
    A beat still in flight when the app stops would land after the
    breaker's ``mark_down`` and clear it."""
    deadline = time.monotonic() + timeout_s
    last = router.membership.snapshot().get(rid, {}).get("seq")
    while time.monotonic() < deadline:
        time.sleep(2 * period_s)
        seq = router.membership.snapshot().get(rid, {}).get("seq")
        if seq == last:
            return
        last = seq
    raise AssertionError(f"{rid}'s heartbeats did not settle in {timeout_s} s")


def test_router_fails_over_when_an_app_stops(fleet):
    """A router over ``HTTPReplica``s a and b; app a stops; requests affine
    to a are served by b, none lost, the breaker marks a down; the same
    outcome over reference apps and the reference router."""
    got = {}
    for side, f in _sides(fleet):
        mod = ROUTER[side]
        router = mod.Router(mod.RouterConfig(heartbeat_s=0.05, suspect_after_s=5.0,
                                             down_after_s=20.0), broker=f["broker"])
        router.start()
        try:
            for rid, node in f["nodes"].items():
                router.add_replica(mod.HTTPReplica(rid, node["url"], breaker_threshold=2,
                                                   breaker_interval=60.0,
                                                   on_breaker_open=router.mark_replica_down))
            deadline = time.monotonic() + 30
            while (any(router.membership.state_of(r) != "UP" for r in ("a", "b"))
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            prompts = _affine_prompts(router, "a", 4, seed=5)
            before = router.submit(prompts[0], max_new_tokens=4, temperature=0.0,
                                   stream_cb=lambda *a: None).result(timeout=TIMEOUT)
            a = f["nodes"]["a"]
            a["ann"].stop(final_beat=False)
            _wait_beats_settled(router, "a", period_s=0.05)
            stop_app(a["app"], a["thread"])
            rows = []
            for p in prompts:
                frames, cb = _frames()
                r = router.submit(p, max_new_tokens=4, temperature=0.0,
                                  stream_cb=cb).result(timeout=TIMEOUT)
                rows.append((r.replica_id, r.token_ids, r.finish_reason,
                             [t for t, _, d in frames if not d] == r.token_ids))
            state = router.membership.state_of("a")
        finally:
            router.stop()
        got[side] = (before.replica_id, rows, state)
    assert got["port"] == got["ref"]
    before, rows, state = got["port"]
    assert before == "a" and state == "DOWN"
    assert all(r[0] == "b" and r[3] for r in rows) and len(rows) == 4
