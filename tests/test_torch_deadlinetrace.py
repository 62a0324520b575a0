"""The port's runtime deadline tracer (gofr_tpu_torch/analysis/
deadlinetrace.py) against the JAX package's.

- The monitor's invariants (monotone narrowing per thread, no negative
  budget, zero and None budgets legal) on the same scripted crossings
  through both packages' monitors.
- install/uninstall, the export merge, and the port's deadline-bounded
  seams the tracer watches (the SSE frame loop, the migrator's clamped
  fetches, the LoRA acquire's clamped wait).
- A Router over two LocalReplicas with deadlines runs on both packages
  under their tracers: neither shows a violation, both cross the same set
  of sites, and the port's crossings are covered by its static table.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.analysis import deadlinetrace as jdeadlinetrace  # noqa: E402
from gofr_tpu_torch.analysis import deadlinetrace  # noqa: E402
from gofr_tpu_torch.analysis.deadlinecheck import (  # noqa: E402
    build_boundary_table,
    check_deadline_coverage,
)
from gofr_tpu_torch.analysis.deadlinetrace import DeadlineTraceError  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = [os.path.join(REPO_ROOT, p) for p in
             ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")]
TRACERS = {"ref": jdeadlinetrace, "port": deadlinetrace}
BOTH = pytest.mark.parametrize("side", sorted(TRACERS))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------ monitor invariants
@BOTH
def test_clean_nesting_no_violations(side):
    mon = TRACERS[side].DeadlineTraceMonitor()
    mon.enter("Router.submit", 1.0)
    mon.enter("ServingEngine.submit", 0.5)
    mon.exit("ServingEngine.submit")
    mon.exit("Router.submit")
    assert mon.violations() == []
    mon.check()


@BOTH
def test_widened_budget_is_a_violation(side):
    mon = TRACERS[side].DeadlineTraceMonitor()
    mon.enter("Router.submit", 0.5)
    mon.enter("AdapterRegistry.acquire", 5.0)
    assert any("budget widened at AdapterRegistry.acquire" in v for v in mon.violations())
    with pytest.raises(AssertionError):
        mon.check()


@BOTH
def test_negative_budget_is_a_dead_crossing(side):
    mon = TRACERS[side].DeadlineTraceMonitor()
    mon.enter("KVMigrator.fetch_chain", -0.25)
    assert any("expired request crossed boundary" in v for v in mon.violations())


@BOTH
def test_zero_and_none_budgets_are_legal(side):
    mon = TRACERS[side].DeadlineTraceMonitor()
    mon.enter("Router.submit", 1.0)
    mon.enter("KVMigrator.fetch_chain", 0.0)
    mon.exit("KVMigrator.fetch_chain")
    mon.enter("LocalReplica.submit", None)
    mon.enter("ServingEngine.submit", 0.5)  # checked against Router's
    assert mon.violations() == []
    mon.enter("AdapterRegistry.acquire", 50.0)  # still must narrow
    assert len(mon.violations()) == 1


@BOTH
def test_sibling_crossings_each_checked(side):
    mon = TRACERS[side].DeadlineTraceMonitor()
    mon.enter("Router.submit", 1.0)
    mon.enter("KVMigrator.fetch_chain", 0.2)
    mon.exit("KVMigrator.fetch_chain")
    mon.enter("KVMigrator.fetch_handoff", 30.0)
    assert len(mon.violations()) == 1
    assert mon.crossings() == ["Router.submit", "KVMigrator.fetch_chain",
                               "KVMigrator.fetch_handoff"]


@BOTH
def test_narrowing_is_per_thread(side):
    """A worker thread's crossing is not nested under another thread's
    enclosing deadline: the router walks replicas on worker threads."""
    mon = TRACERS[side].DeadlineTraceMonitor()
    mon.enter("Router.submit", 0.1)
    t = threading.Thread(target=lambda: mon.enter("ServingEngine.submit", 30.0))
    t.start()
    t.join(10)
    assert mon.violations() == []
    mon.enter("ServingEngine.submit", 30.0)  # the same thread: widened
    assert len(mon.violations()) == 1


def test_export_shape_and_merge(tmp_path):
    mon = deadlinetrace.DeadlineTraceMonitor()
    mon.enter("Router.submit", 1.0)
    mon.exit("Router.submit")
    path = str(tmp_path / "deadline.json")
    deadlinetrace.export_to(mon, path)
    mon2 = deadlinetrace.DeadlineTraceMonitor()
    mon2.enter("ServingEngine.submit", 0.5)
    mon2.exit("ServingEngine.submit")
    deadlinetrace.export_to(mon2, path)
    with open(path, encoding="utf-8") as fp:
        data = json.load(fp)
    assert [e["site"] for e in data["events"]] == ["Router.submit", "ServingEngine.submit"]
    assert data["violations"] == []


def test_install_uninstall_restores_originals():
    from gofr_tpu_torch.serving import remote
    from gofr_tpu_torch.serving.router import Router

    before, before_stream = Router.submit, remote.run_stream
    mon = deadlinetrace.install()
    try:
        assert Router.submit is not before
        assert getattr(Router.submit, "__wrapped__", None) is before
        with pytest.raises(DeadlineTraceError):
            deadlinetrace.install()
    finally:
        assert deadlinetrace.uninstall() is mon
    assert Router.submit is before and remote.run_stream is before_stream
    assert deadlinetrace.uninstall() is None


# ------------------------------------------------- the bounded seams
class _FakeResp:
    def __init__(self, frames):
        self._frames = frames

    def lines(self):
        yield from self._frames


def test_iter_events_bounded_by_the_deadline():
    from gofr_tpu_torch.http.errors import ErrorDeadlineExceeded
    from gofr_tpu_torch.serving.remote import iter_events

    frames = ['data: {"id": 7}', 'data: {"token": 1, "text": "a"}', "data: [DONE]"]
    with pytest.raises(ErrorDeadlineExceeded):
        next(iter_events(_FakeResp(frames), deadline_abs=time.monotonic() - 0.01))
    assert list(iter_events(_FakeResp(frames), deadline_abs=time.monotonic() + 30)) == [
        {"id": 7}, {"token": 1, "text": "a"}]
    assert list(iter_events(_FakeResp(frames))) == [{"id": 7}, {"token": 1, "text": "a"}]


class _RecordingPeer:
    def __init__(self):
        self.calls: list = []

    def __call__(self, keys, timeout: float = 2.0):
        self.calls.append((list(keys), timeout))
        return {k: (1, 2, 3) for k in keys}


def test_migrator_fetches_clamped_to_the_deadline():
    from gofr_tpu_torch.serving.prefix_index import KVMigrator, PrefixIndex

    peer = _RecordingPeer()
    mig = KVMigrator("B", PrefixIndex(), fetch_timeout_s=2.0)
    mig.add_peer("A", peer)
    spans = [(0, 16, "k0"), (16, 32, "k1")]
    # an expired request never touches the wire
    assert mig.fetch_handoff(spans, "A", deadline=0.0) == []
    assert mig.fetch_chain(spans, deadline=-1.0) == []
    assert peer.calls == []
    got = mig.fetch_handoff(spans, "A", deadline=0.75)
    assert [s[:2] for s in got] == [(0, 16), (16, 32)]
    assert peer.calls[-1][1] == pytest.approx(0.75)
    mig.fetch_handoff(spans, "A", deadline=30.0)
    assert peer.calls[-1][1] == pytest.approx(2.0)


def _tiny():
    from gofr_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(vocab_size=300)
    return cfg, llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def test_lora_acquire_clamped_to_the_request_deadline():
    from gofr_tpu_torch.serving import AdapterRegistry, make_adapter
    from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg, params = _tiny()
    reg = AdapterRegistry(max_active=4, device="cpu")
    reg.register(make_adapter(cfg, "tenant-a", rank=2, seed=1))
    mon = deadlinetrace.install()
    try:
        eng = ServingEngine(cfg, params, EngineConfig(max_slots=2, max_seq_len=128,
                                                      prefill_buckets=(16,), max_queue=8),
                            ByteTokenizer(), device="cpu", lora=reg)
        eng.start()
        try:
            r = eng.submit("hi", max_new_tokens=2, adapter_id="tenant-a",
                           deadline=30.0).result(timeout=120)
            assert r.finish_reason in ("stop", "length")
        finally:
            eng.stop()
    finally:
        deadlinetrace.uninstall()
    mon.check()  # the acquire's wait narrowed below the request's budget
    assert {"ServingEngine.submit", "AdapterRegistry.acquire"} <= mon.observed_sites()
    assert check_deadline_coverage(mon.export(), build_boundary_table(PORT_TREE)) == []


# ------------------------------------------ a router on both packages
BEAT_S = 0.05


def _route_both_ways(side: str, models) -> tuple:
    """Two LocalReplicas behind a Router with deadlines: a few submits and
    one keyed re-attach through the router. Returns (sites crossed,
    violations, finish reasons, the monitor)."""
    jcfg, jparams, tcfg, tparams = models
    conf = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32), max_queue=16)
    if side == "ref":
        from gofr_tpu.datasource.pubsub import InMemoryBroker
        from gofr_tpu.serving import ByteTokenizer, EngineConfig, ServingEngine
        from gofr_tpu.serving import membership as ms
        from gofr_tpu.serving import router as rt

        def engine():
            return ServingEngine(jcfg, jparams, EngineConfig(**conf), ByteTokenizer())
    else:
        from gofr_tpu_torch.pubsub import InMemoryBroker
        from gofr_tpu_torch.serving import membership as ms
        from gofr_tpu_torch.serving import router as rt
        from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
        from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

        def engine():
            return ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(),
                                 device="cpu")

    tracer = TRACERS[side]
    mon = tracer.install()
    broker = InMemoryBroker(consumer_group="router", poll_timeout=0.02)
    router = rt.Router(rt.RouterConfig(heartbeat_s=BEAT_S, suspect_after_s=30.0,
                                       down_after_s=60.0), broker=broker)
    engines, announcers = {}, []
    try:
        router.start()
        for rid in ("a", "b"):
            e = engine()
            e.start()
            engines[rid] = e
            router.add_replica(rt.LocalReplica(rid, e))
            ann = ms.ReplicaAnnouncer(rid, e, broker, interval_s=BEAT_S)
            ann.start()
            announcers.append(ann)
        end = time.monotonic() + 60
        while not all(router.membership.state_of(r) == "UP" for r in engines):
            assert time.monotonic() < end, "replicas never came UP"
            time.sleep(0.005)
        reasons = []
        for i in range(4):
            r = router.submit(f"prompt {i}", max_new_tokens=4, temperature=0.0,
                              deadline=60.0).result(120)
            reasons.append(r.finish_reason)
        keyed = router.submit("keyed prompt", max_new_tokens=6, temperature=0.0,
                              deadline=60.0, idempotency_key="k1")
        reasons.append(keyed.result(120).finish_reason)
        frames = []
        resumed = router.resume("k1", last_seq=0, deadline=60.0,
                                stream_cb=lambda seq, tok, piece, done: frames.append(seq))
        reasons.append(resumed.result(120).finish_reason)
    finally:
        for ann in announcers:
            ann.stop(final_beat=False)
        router.stop()
        for e in engines.values():
            e.stop()
        tracer.uninstall()
    return mon.observed_sites(), mon.violations(), reasons, mon


@pytest.fixture(scope="module")
def models():
    from gofr_tpu.models import llama as jllama
    from gofr_tpu_torch.models import llama as tllama
    from gofr_tpu_torch.models.convert import params_from_jax

    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def test_router_over_two_local_replicas_on_both_packages(models):
    ref_sites, ref_viol, ref_reasons, _ = _route_both_ways("ref", models)
    port_sites, port_viol, port_reasons, mon = _route_both_ways("port", models)
    assert ref_viol == [] and port_viol == []
    assert port_sites == ref_sites, (port_sites, ref_sites)
    assert {"Router.submit", "LocalReplica.submit", "ServingEngine.submit",
            "Router.resume", "LocalReplica.resume"} <= port_sites
    assert port_reasons == ref_reasons
    assert check_deadline_coverage(mon.export(), build_boundary_table(PORT_TREE)) == []
