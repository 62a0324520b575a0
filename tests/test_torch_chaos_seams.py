"""The two chaos points of the port's ``chaos/injector.py`` that no other
port test schedules, each held to the reference's case and run on both
packages:

- ``service.request`` fires inside the service client before the socket
  (``service/client.py``): under ``max_faults=2`` the Retry option ladder
  absorbs two injected transport faults, the request then goes through,
  and the injector's stats count 2 faults (the reference's
  ``tests/test_chaos.py::test_service_client_injection_point``);
- ``stream.resume`` fires at a keyed re-attach's admission
  (``serving/engine.py``): a client that re-attaches by key and
  ``last_seq`` through a Router, retrying faulted attempts, gets the
  token-identical suffix of the uninterrupted run, densely numbered with
  one terminal last (the reference's
  ``tests/test_ha.py::test_router_crash_mid_stream_resume_token_identical``,
  without the router crash: the re-attach goes through the same router).
"""

from __future__ import annotations

import http.server
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu_torch import chaos  # noqa: E402
from gofr_tpu_torch.chaos import ChaosInjector  # noqa: E402

CHAOS_SEEDS = (101, 202, 303)
PROMPT = "resume me exactly once "
MAX_NEW = 24
BEAT_S = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ service.request
class _Ok(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("side", ["ref", "port"])
def test_service_request_faults_are_absorbed_by_the_retry_ladder(side):
    if side == "ref":
        from gofr_tpu.service import new_http_service
        from gofr_tpu.service.options import RetryConfig
        mod = jchaos
    else:
        from gofr_tpu_torch.service import new_http_service
        from gofr_tpu_torch.service.options import RetryConfig
        mod = chaos
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Ok)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        svc = new_http_service(f"http://127.0.0.1:{server.server_port}", None, None, None,
                               RetryConfig(max_retries=3, backoff=0.001))
        inj = mod.ChaosInjector(5, {"service.request": 1.0}, max_faults=2)
        with mod.active(inj):
            resp = svc.get("x")  # two injected transport faults, then through
        assert resp.ok
        assert inj.stats()["service.request"]["faults"] == 2
    finally:
        server.shutdown()
        thread.join(10)


def test_service_request_fires_before_the_socket():
    """With every attempt faulted the server sees no request at all."""
    from gofr_tpu_torch.service import new_http_service

    hits = []

    class Counting(_Ok):
        def do_GET(self):
            hits.append(self.path)
            super().do_GET()

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Counting)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        svc = new_http_service(f"http://127.0.0.1:{server.server_port}")
        inj = ChaosInjector(5, {"service.request": 1.0}, max_faults=1)
        with chaos.active(inj), pytest.raises(Exception):
            svc.get("x")
        assert hits == [] and inj.stats()["service.request"]["faults"] == 1
        assert svc.get("x").ok and hits == ["/x"]
    finally:
        server.shutdown()
        thread.join(10)


# -------------------------------------------------------------- stream.resume
@pytest.fixture(scope="module")
def models():
    from gofr_tpu.models import llama as jllama
    from gofr_tpu_torch.models import llama as tllama
    from gofr_tpu_torch.models.convert import params_from_jax

    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def _resume_under_faults(side: str, models, seed: int) -> dict:
    """Control run, then a keyed stream acked after 4 frames and re-attached
    under ``stream.resume`` faults through a Router over two replicas."""
    jcfg, jparams, tcfg, tparams = models
    conf = dict(max_slots=6, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
                prefill_chunk_tokens=16)
    if side == "ref":
        from gofr_tpu.datasource.pubsub import InMemoryBroker
        from gofr_tpu.http.errors import ErrorEntityNotFound
        from gofr_tpu.serving import ByteTokenizer, EngineConfig, ServingEngine
        from gofr_tpu.serving import membership as ms
        from gofr_tpu.serving import router as rt
        mod = jchaos

        def engine():
            return ServingEngine(jcfg, jparams, EngineConfig(**conf), ByteTokenizer())
    else:
        from gofr_tpu_torch.http.errors import ErrorEntityNotFound
        from gofr_tpu_torch.pubsub import InMemoryBroker
        from gofr_tpu_torch.serving import membership as ms
        from gofr_tpu_torch.serving import router as rt
        from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
        from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
        mod = chaos

        def engine():
            return ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(),
                                 device="cpu")

    broker = InMemoryBroker(consumer_group="router")
    router = rt.Router(rt.RouterConfig(heartbeat_s=BEAT_S, suspect_after_s=6 * BEAT_S,
                                       down_after_s=40 * BEAT_S, max_failovers=3),
                       broker=broker)
    engines, announcers = [], []
    for i in range(2):
        e = engine()
        engines.append(e)
        router.add_replica(rt.LocalReplica(f"rep-{i}", e))
        announcers.append(ms.ReplicaAnnouncer(f"rep-{i}", e, broker, interval_s=BEAT_S))
    for e in engines:
        e.start()
    router.start()
    for a in announcers:
        a.start()
    try:
        end = time.monotonic() + 60
        while not all(router.membership.state_of(f"rep-{i}") == "UP" for i in range(2)):
            assert time.monotonic() < end, "replicas never came UP"
            time.sleep(0.005)
        control = router.submit(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0).result(120)
        assert len(control.token_ids) == MAX_NEW
        key = f"seam-{seed}"
        frames: list = []
        saw_enough = threading.Event()

        def client_cb(token_id, piece, done):
            if not done:
                frames.append(token_id)
                if len(frames) >= 4:
                    saw_enough.set()

        inj = mod.ChaosInjector(seed, {"stream.resume": 0.5}, max_faults=3)
        with mod.active(inj):
            fut = router.submit(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0,
                                idempotency_key=key, stream_cb=client_cb)
            assert saw_enough.wait(120), "stream never started"
            acked = 4
            resumed: list = []
            last = None
            for _ in range(20):  # the documented client loop: retry a faulted re-attach
                try:
                    fut2 = router.resume(key, last_seq=acked,
                                         stream_cb=lambda s, t, p, d: resumed.append((s, t, d)))
                    break
                except (ErrorEntityNotFound, *rt.RETRIABLE_ERRORS) as exc:
                    last = exc
                    time.sleep(0.05)
            else:
                raise AssertionError(f"resume never converged: {last!r}")
            result = fut2.result(120)
        end = time.monotonic() + 60
        while time.monotonic() < end and (not resumed or not resumed[-1][2]):
            time.sleep(0.01)
        return {"control": control.token_ids, "result": result.token_ids,
                "first": fut.result(5).token_ids, "resumed": resumed, "acked": acked,
                "faults": inj.stats()["stream.resume"]["faults"]}
    finally:
        for a in announcers:
            a.stop(final_beat=False)
        router.stop()
        for e in engines:
            e.stop()


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_keyed_resume_under_stream_resume_faults_is_token_identical(models, seed):
    outs = {side: _resume_under_faults(side, models, seed) for side in ("ref", "port")}
    for side, out in outs.items():
        assert out["result"] == out["control"] == out["first"], side
        resumed, acked = out["resumed"], out["acked"]
        assert resumed and resumed[-1][2] is True, side
        assert [f[0] for f in resumed] == list(range(acked + 1, acked + 1 + len(resumed))), side
        assert [f[1] for f in resumed if not f[2]] == out["control"][acked:], side
    # the same greedy tokens in both packages, and the same fault schedule
    assert outs["port"]["control"] == outs["ref"]["control"]
    assert outs["port"]["faults"] == outs["ref"]["faults"]


def test_stream_resume_fault_is_a_retriable_refusal_at_the_engine(models):
    """Every faulted re-attach raises a fault the router retries
    (``RETRIABLE_ERRORS``) before anything is replayed; once the budget is
    spent the re-attach replays the whole stream."""
    from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.router import RETRIABLE_ERRORS
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    _, _, tcfg, tparams = models
    engine = ServingEngine(tcfg, tparams, EngineConfig(max_slots=2, max_seq_len=128,
                                                       prefill_buckets=(16,)),
                           ByteTokenizer(), device="cpu")
    engine.start()
    try:
        done = engine.submit(PROMPT, max_new_tokens=8, idempotency_key="k").result(60)
        inj = ChaosInjector(7, {"stream.resume": 1.0}, max_faults=2)
        frames: list = []
        with chaos.active(inj):
            for _ in range(2):
                with pytest.raises(RETRIABLE_ERRORS):
                    engine.resume("k", last_seq=0, stream_cb=lambda *f: frames.append(f))
            assert frames == []
            again = engine.resume("k", last_seq=0,
                                  stream_cb=lambda s, t, p, d: frames.append((s, t, d)))
            assert again.result(60).token_ids == done.token_ids
        assert inj.stats()["stream.resume"]["faults"] == 2
        end = time.monotonic() + 30
        while time.monotonic() < end and (not frames or not frames[-1][2]):
            time.sleep(0.01)
        assert [f[1] for f in frames if not f[2]] == done.token_ids
    finally:
        engine.stop()
