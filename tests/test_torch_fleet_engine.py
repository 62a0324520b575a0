"""The fleet tier over real engines: a port ``Router`` over port engines
against a reference ``Router`` over JAX engines, on the CPU at
``LlamaConfig.tiny`` (vocab 300, the JAX package's params carried across),
heartbeats published by each side's ``ReplicaAnnouncer`` on each side's
``InMemoryBroker`` and consumed by the router's membership loop:

- the same prompts reach the same replicas with the same greedy tokens,
  and an affine repeat is a prefix-cache hit on both sides;
- after a ``warm_restart`` of the affine replica the router's stale fence
  epoch is refused (409) and the request goes to the other replica; a
  fresh beat brings the affine replica back;
- a ``decode.dispatch`` fault fails a chunked request before its first
  token on the affine replica, and the router fails it over (the port's
  failure settlement fails the future before the done frame: Queue C 25);
- P/D through ``_submit_disagg``: the prefill replica computes, the decode
  replica admits the handed-off chain with no prefill compute, the
  unified tokens, and ``app_kv_handoffs_total`` 1;
- an autoscaler scale-up whose factory builds an engine (the port's
  ``engine_factory``), and the new replica serves.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu.datasource.pubsub import InMemoryBroker as JBroker  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import autoscaler as jauto  # noqa: E402
from gofr_tpu.serving import batch as jbatch  # noqa: E402
from gofr_tpu.serving import membership as jms  # noqa: E402
from gofr_tpu.serving import prefix_index as jpi  # noqa: E402
from gofr_tpu.serving import router as jrouter  # noqa: E402
from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.pubsub import InMemoryBroker  # noqa: E402
from gofr_tpu_torch.serving import autoscaler as tauto  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving import membership as tms  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as tpi  # noqa: E402
from gofr_tpu_torch.serving import router as trouter  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), max_queue=32,
            prefill_chunk_tokens=16, prefix_cache_entries=32, kv_layout="paged", kv_page_size=8)
PROMPTS = ["the fleet's shared system prompt, one", "a second tenant's system prompt",
           "short", "the fleet's shared system prompt, one"]
HANDED = "a prompt handed from prefill to decode " * 2
BEAT_S = 0.05
TIMEOUT = 120


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


class Metrics:
    """Records the counters a migrator increments."""

    def __init__(self) -> None:
        self.counts: dict[str, int] = {}

    def increment_counter(self, name, *args, **labels) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1


class Side:
    """One package's engines, router, membership, broker and chaos tier."""

    def __init__(self, models, name: str) -> None:
        jcfg, jparams, tcfg, tparams = models
        self.jax = name == "jax"
        self.rt, self.ms, self.pi = (jrouter, jms, jpi) if self.jax else (trouter, tms, tpi)
        self.auto, self.batch = (jauto, jbatch) if self.jax else (tauto, tbatch)
        self.chaos = jchaos if self.jax else tchaos
        self.cfg, self.params = (jcfg, jparams) if self.jax else (tcfg, tparams)
        self.broker = (JBroker if self.jax else InMemoryBroker)(consumer_group="router",
                                                                poll_timeout=0.02)
        self.router = self.rt.Router(self.rt.RouterConfig(
            heartbeat_s=BEAT_S, suspect_after_s=30.0, down_after_s=60.0), broker=self.broker)
        self.router.start()
        self.engines: dict = {}
        self.announcers: dict = {}

    def engine(self, **kw):
        conf = {**BASE, **kw}
        if self.jax:
            return JServingEngine(self.cfg, self.params, JEngineConfig(**{
                k: v for k, v in conf.items() if k != "kv_migrator"}), JByteTokenizer(),
                kv_migrator=conf.get("kv_migrator"))
        migrator = conf.pop("kv_migrator", None)
        return ServingEngine(self.cfg, self.params, EngineConfig(**conf), ByteTokenizer(),
                             device="cpu", kv_migrator=migrator)

    def add(self, rid: str, engine, interval_s: float = BEAT_S) -> None:
        """Start the engine, register it and announce it over the broker."""
        engine.start()
        self.engines[rid] = engine
        self.router.add_replica(self.rt.LocalReplica(rid, engine))
        ann = self.ms.ReplicaAnnouncer(rid, engine, self.broker, interval_s=interval_s)
        self.announcers[rid] = ann
        ann.start()

    def wait_up(self, *rids: str) -> None:
        """Until each replica's newest beat (and its epoch) has landed."""
        end = time.monotonic() + TIMEOUT
        while not all(self.router.membership.state_of(r) == "UP"
                      and self.router.membership.epoch_of(r) == self.engines[r].epoch
                      for r in rids):
            assert time.monotonic() < end, "replicas never came UP"
            time.sleep(0.005)

    def affine(self, rid: str, tag: str) -> str:
        for i in range(400):
            prompt = f"{tag} {i}"
            if self.router._candidates_for(prompt)[0][:1] == [rid]:
                return prompt
        raise AssertionError(f"no prompt affine to {rid}")

    def route(self, prompt, **kw) -> tuple:
        r = self.router.submit(prompt, max_new_tokens=6, temperature=0.0, deadline=TIMEOUT,
                               **kw).result(TIMEOUT)
        return r.replica_id, r.token_ids, r.finish_reason

    def close(self) -> None:
        for ann in self.announcers.values():
            ann.stop(final_beat=False)
        self.router.stop()
        for engine in self.engines.values():
            engine.stop()


def _sides(models, scenario):
    outs = []
    for name in ("jax", "port"):
        side = Side(models, name)
        try:
            outs.append(scenario(side))
        finally:
            side.close()
    assert outs[1] == outs[0]
    return outs[1]


def test_affine_routes_tokens_and_hits(models):
    def scenario(side):
        for rid in ("e1", "e2"):
            side.add(rid, side.engine())
        side.wait_up("e1", "e2")
        routed = [side.route(p) for p in PROMPTS]
        repeat_rid = routed[-1][0]
        hits = side.engines[repeat_rid]._prefix_cache.stats()["hits"]
        z = side.router.routerz()
        return {"routed": routed, "hits": hits, "routes": z["counters"]["routes_by_replica"],
                "roles": z["roles_present"]}

    out = _sides(models, scenario)
    assert out["routed"][0] == out["routed"][3] and out["hits"] >= 1
    assert out["roles"] == ["unified"]


def test_stale_fence_after_warm_restart_goes_to_the_other_replica(models):
    def scenario(side):
        for rid in ("e1", "e2"):
            side.add(rid, side.engine(), interval_s=3600.0)  # one beat each, at start
        side.wait_up("e1", "e2")
        prompt = side.affine("e1", "fenced")
        first = side.route(prompt)
        assert side.engines["e1"].warm_restart()
        stale = side.route(prompt)  # the router still stamps e1's old epoch
        side.announcers["e1"].beat()
        side.wait_up("e1")
        fresh = side.route(prompt)
        return {"first": first, "stale": stale, "fresh": fresh,
                "counters": side.router._counters()}

    out = _sides(models, scenario)
    assert out["first"][0] == "e1" and out["stale"][0] == "e2" and out["fresh"][0] == "e1"
    assert out["first"][1] == out["stale"][1] == out["fresh"][1]
    assert out["counters"]["failovers_total"] == 0  # an admission walk, not a failover


def test_fault_before_the_first_token_fails_over(models):
    def scenario(side):
        for rid in ("e1", "e2"):
            side.add(rid, side.engine())
        side.wait_up("e1", "e2")
        # longer than a chunk: its first token comes from the ragged dispatch
        prompt = side.affine("e1", "a faulted prompt, longer than one chunk,")
        with side.chaos.active(side.chaos.ChaosInjector(101, {"decode.dispatch": 1.0},
                                                        max_faults=1)):
            served = side.route(prompt)
        return {"served": served, "failovers": side.router.failovers_total,
                "clean": side.route(prompt)}

    out = _sides(models, scenario)
    assert out["served"][0] == "e2" and out["failovers"] == 1
    assert out["clean"][0] == "e1" and out["clean"][1] == out["served"][1]


def test_prefill_decode_split_hands_off(models, monkeypatch):
    def scenario(side):
        unified = side.engine()
        unified.start()
        try:
            want = unified.submit(HANDED, max_new_tokens=6, temperature=0.0).result(TIMEOUT)
        finally:
            unified.stop()
        metrics = Metrics()
        migrator = side.pi.KVMigrator("dec", side.router.prefix_index, metrics=metrics)
        pre = side.engine(role="prefill")
        dec = side.engine(role="decode", kv_migrator=migrator)
        migrator.add_peer("pre", side.pi.local_engine_fetcher(pre))
        side.add("pre", pre)
        side.add("dec", dec)
        side.wait_up("pre", "dec")
        computes = {"pre": 0, "dec": 0}
        real = side.batch.prefill_compute

        def counted(*a, **k):
            for rid in ("pre", "dec"):
                if threading.current_thread() is side.engines[rid]._thread:
                    computes[rid] += 1
            return real(*a, **k)

        monkeypatch.setattr(side.batch, "prefill_compute", counted)
        real_ragged = {rid: side.engines[rid]._dispatch_ragged for rid in ("pre", "dec")}
        ragged = {"pre": 0, "dec": 0}
        for rid in ("pre", "dec"):
            def wrap(*a, _rid=rid, **k):
                ragged[_rid] += 1
                return real_ragged[_rid](*a, **k)
            monkeypatch.setattr(side.engines[rid], "_dispatch_ragged", wrap)
        try:
            got = side.route(HANDED)
        finally:
            monkeypatch.undo()
        return {"got": got, "equal": got[1] == want.token_ids, "computes": computes,
                "ragged": ragged, "handoffs": side.router.handoffs_total,
                "app_kv_handoffs_total": metrics.counts.get("app_kv_handoffs_total", 0)}

    out = _sides(models, scenario)
    assert out["got"][0] == "dec" and out["equal"]
    assert out["computes"]["dec"] == 0 and out["ragged"]["dec"] == 0
    assert out["computes"]["pre"] + out["ragged"]["pre"] > 0
    assert out["handoffs"] == 1 and out["app_kv_handoffs_total"] == 1


def test_autoscaler_scale_up_builds_a_serving_engine(models):
    def scenario(side):
        if side.jax:
            def factory(role, rid, preemptible=False):
                engine = side.engine(role=role, preemptible=preemptible)
                engine.start()
                side.engines[rid] = engine
                ann = side.ms.ReplicaAnnouncer(rid, engine, side.broker, interval_s=BEAT_S)
                side.announcers[rid] = ann
                ann.start()
                return side.rt.LocalReplica(rid, engine, role=role)
        else:
            built = tauto.engine_factory(side.cfg, side.params, EngineConfig(**BASE),
                                         publisher=side.broker, heartbeat_s=BEAT_S, device="cpu")

            def factory(role, rid, preemptible=False):
                handle = built(role, rid, preemptible)
                side.engines[rid], side.announcers[rid] = handle.engine, handle.announcer
                return handle
        driver = side.auto.SimulatedPoolDriver(side.router, factory)
        scaler = side.auto.Autoscaler(side.router, driver, side.auto.AutoscalerConfig(
            min_replicas=1, max_replicas=2, up_stable_s=0.5, down_stable_s=1.0, cooldown_s=1.0))
        (first,) = driver.scale_up("unified", 1)
        side.wait_up(first)
        side.announcers[first].stop(final_beat=False)
        # the first replica's last beat reports a backed-up queue
        side.router.membership.observe(side.ms.Heartbeat(first, 10_000, queue_wait_s=5.0))
        scaler.tick(now=100.0)  # past the cooldown of a scaler that never acted
        scaler.tick(now=100.6)
        added = [r for r in driver.replica_ids("unified") if r != first]
        side.wait_up(*added)
        served = side.route("after the scale-up")  # the first spills past its queue
        decisions = [{k: v for k, v in d.items() if k != "t"} for d in scaler.decisions]
        return {"decisions": decisions, "added": added, "served": served,
                "engine_type": type(side.engines[added[0]]).__module__.split(".")[0]}

    outs = []
    for name in ("jax", "port"):
        side = Side(models, name)
        try:
            outs.append(scenario(side))
        finally:
            side.close()
    jax_out, port_out = outs
    assert port_out["engine_type"] == "gofr_tpu_torch" and jax_out["engine_type"] == "gofr_tpu"
    for out in outs:
        out.pop("engine_type")
    assert port_out == jax_out
    assert [d["direction"] for d in port_out["decisions"]] == ["up"]
    assert port_out["served"][0] == port_out["added"][0]
