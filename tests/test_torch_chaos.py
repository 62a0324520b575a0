"""The port's chaos module against the JAX package's, and the chaos points
it wires into the port engine.

``gofr_tpu_torch.chaos`` is a copy of ``gofr_tpu.chaos``: the same
``POINTS``, the same per-(seed, point) streams, the same wall-clock
schedules, held here call for call (exact: fire sequences, fault types and
messages, ``stats()``). Each package's injector is its own global. The
engine half drives the points wired into the port engine on the CPU at the
reference's chaos size (two layers, d_model 32): every request reaches one
terminal state (a finish reason or a typed error), slots and pages come
back, and the engine still serves, as ``tests/test_chaos.py`` requires of
the reference.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu_torch import chaos  # noqa: E402
from gofr_tpu_torch.errors import (  # noqa: E402
    ErrorDeadlineExceeded,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.models import llama  # noqa: E402
from gofr_tpu_torch.serving import (  # noqa: E402
    AdapterRegistry,
    TenantPolicy,
    TenantRegistry,
    make_adapter,
)
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.kv_cache import OutOfBlocks  # noqa: E402
from gofr_tpu_torch.serving.kv_spill import TieredPrefixCache  # noqa: E402
from gofr_tpu_torch.serving.scheduler import QueueFull  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

CHAOS_SEEDS = (101, 202, 303)
RATES = (0.05, 0.3, 1.0)
TERMINAL_ERRORS = (ErrorTooManyRequests, ErrorServiceUnavailable, ErrorDeadlineExceeded,
                   chaos.ChaosFault)
TERMINAL_REASONS = {"stop", "length", "kv_exhausted", "cancel", "deadline_exceeded"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------- the injector
def _fires(module, seed: int, rate: float, n: int = 1000) -> list:
    """Each point's 1000 calls on an injector of ``module``: (call index,
    fault type name, message) per fault, then ``stats()``."""
    inj = module.ChaosInjector(seed, {p: rate for p in module.POINTS})
    fired = []
    for point in module.POINTS:
        for i in range(n):
            try:
                inj.fire(point)
            except Exception as exc:
                fired.append((point, i, type(exc).__name__, str(exc)))
    return fired, inj.stats()


def test_points_are_the_reference_tuple():
    assert chaos.POINTS == jchaos.POINTS


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fire_sequences_match_the_reference(seed, rate):
    """The same seed and rate fault the same calls of every point, with
    faults of the same type and message, and the same stats."""
    assert _fires(chaos, seed, rate) == _fires(jchaos, seed, rate)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_fault_budget_and_schedule_match_the_reference(seed):
    """``max_faults`` caps each point alike, and ``FaultSchedule.seeded``
    places the same windows; claims at pinned clock offsets agree."""
    outs = []
    for module in (chaos, jchaos):
        inj = module.ChaosInjector(seed, {"decode.dispatch": 0.5, "kv.alloc": 0.2},
                                   max_faults=7)
        fired = []
        for point in ("decode.dispatch", "kv.alloc"):
            for i in range(300):
                try:
                    inj.fire(point)
                except Exception as exc:
                    fired.append((point, i, type(exc).__name__))
        sched = module.FaultSchedule.seeded(seed, 10.0, ["engine.step", "device.loss"],
                                            per_point=3, duration_s=0.5, rate=0.5,
                                            max_faults=2)
        sched.arm(epoch=0.0)
        claims = []
        for k in range(2000):
            t = k * 0.005
            for point in ("engine.step", "device.loss"):
                f = sched.claim(point, now=t)
                if f is not None:
                    claims.append((k, point, f.at_s))
        windows = [(f.point, f.at_s, f.duration_s, f.rate, f.max_faults) for f in sched.faults]
        outs.append((fired, inj.stats(), windows, claims, sched.stats()))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 14  # both points spent their budget of 7


def test_default_fault_types_are_the_ports_own():
    inj = chaos.ChaosInjector(1, {"kv.alloc": 1.0, "sched.submit": 1.0, "device.loss": 1.0})
    with pytest.raises(OutOfBlocks):
        inj.fire("kv.alloc")
    with pytest.raises(QueueFull):
        inj.fire("sched.submit")
    with pytest.raises(chaos.DeviceLost) as exc_info:
        inj.fire("device.loss")
    assert isinstance(exc_info.value, chaos.ChaosFault) and not exc_info.value.retriable
    with pytest.raises(ValueError):
        chaos.ChaosInjector(1, {"not.a.point": 1.0})


def test_hang_factory_stalls_then_proceeds():
    inj = chaos.ChaosInjector(3, {"engine.step": 1.0}, max_faults=1,
                              fault_factories={"engine.step": chaos.hang_factory(0.05)})
    t0 = time.monotonic()
    inj.fire("engine.step")  # hangs, raises nothing
    assert time.monotonic() - t0 >= 0.05
    assert inj.stats()["engine.step"] == {"calls": 1, "faults": 1}


def test_each_package_arms_only_its_own_points():
    """The port's injector is a global of its own: installing it leaves the
    JAX package's hook quiet, and the other way round; ``active`` always
    uninstalls and ``install`` is exclusive."""
    with chaos.active(chaos.ChaosInjector(5, {"decode.dispatch": 1.0})):
        jchaos.maybe_fail("decode.dispatch")  # quiet
        with pytest.raises(chaos.ChaosFault):
            chaos.maybe_fail("decode.dispatch")
        with pytest.raises(RuntimeError):
            chaos.install(chaos.ChaosInjector(6, {}))
    with jchaos.active(jchaos.ChaosInjector(5, {"decode.dispatch": 1.0})):
        chaos.maybe_fail("decode.dispatch")  # quiet
        with pytest.raises(jchaos.ChaosFault):
            jchaos.maybe_fail("decode.dispatch")
    with pytest.raises(KeyError):
        with chaos.active(chaos.ChaosInjector(5, {"kv.alloc": 1.0})):
            raise KeyError("workload failed")
    chaos.maybe_fail("kv.alloc")  # uninstalled despite the raise


# ------------------------------------------------------- the wired points
def tiny_cfg(max_seq: int = 64) -> llama.LlamaConfig:
    """The reference's chaos size with a vocabulary that holds every byte
    token (the port refuses ids past it; see ``ServingEngine.submit``)."""
    return llama.LlamaConfig(vocab_size=300, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             d_ff=64, max_seq_len=max_seq, dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_cfg()
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def make_engine(model, *, lora=None, tenants=None, **kw) -> ServingEngine:
    cfg, params = model
    conf = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16,), admission_per_step=2,
                max_queue=64)
    conf.update(kw)
    return ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size),
                         device="cpu", lora=lora, tenants=tenants)


def _settle(fut, timeout: float = 60.0) -> str:
    """A future's one terminal state: its finish reason, or the name of a
    typed error."""
    try:
        res = fut.result(timeout=timeout)
    except TERMINAL_ERRORS as exc:
        return type(exc).__name__
    assert res.finish_reason in TERMINAL_REASONS, res.finish_reason
    return res.finish_reason


def _assert_reclaimed(engine: ServingEngine) -> None:
    t_end = time.monotonic() + 10
    while (any(s is not None for s in engine.slots) or engine._by_id) \
            and time.monotonic() < t_end:
        time.sleep(0.005)
    assert all(s is None for s in engine.slots) and not engine._by_id
    assert engine._sched.stats()["busy_slots"] == 0
    if engine.paged_cache is not None:
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"] and stats["sequences"] == 0, stats


def _storm(engine: ServingEngine, n: int = 10, **submit_kw) -> list:
    outcomes = []
    for i in range(n):
        try:
            outcomes.append(engine.submit(f"req {i} " + "x" * (i % 3) * 12,
                                          max_new_tokens=(2, 5, 8)[i % 3], **submit_kw))
        except TERMINAL_ERRORS as exc:
            outcomes.append(exc)
    return [type(o).__name__ if isinstance(o, BaseException) else _settle(o) for o in outcomes]


def _probe(engine: ServingEngine) -> None:
    res = engine.submit("probe", max_new_tokens=2).result(timeout=60)
    assert res.finish_reason in ("stop", "length")


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_scheduler_and_dispatch_points_preserve_the_lifecycle(model, kv_layout):
    """``sched.submit`` (a 429), ``sched.admit``, ``sched.plan`` and
    ``decode.dispatch`` faults, plus ``kv.alloc`` on the paged layout
    (pool pressure: a requeue or an early retire), over a workload of
    short and chunked prompts: one terminal state each, every slot and
    page back, and the engine serves after the storm."""
    kw = dict(kv_layout=kv_layout, max_seq_len=128, prefill_chunk_tokens=8)
    if kv_layout == "paged":
        kw.update(kv_page_size=8, kv_num_pages=24)
    engine = make_engine(model, **kw)
    rates = {"sched.submit": 0.1, "sched.admit": 0.05, "sched.plan": 0.05,
             "decode.dispatch": 0.05}
    if kv_layout == "paged":
        rates["kv.alloc"] = 0.1
    inj = chaos.ChaosInjector(101, rates, max_faults=3)
    engine.start()
    try:
        with chaos.active(inj):
            outcomes = _storm(engine, n=12)
        stats = inj.stats()
        assert sum(s["faults"] for s in stats.values()) > 0, stats
        assert stats["sched.plan"]["calls"] > 0 and stats["sched.admit"]["calls"] > 0
        if "ErrorTooManyRequests" in outcomes:
            assert stats["sched.submit"]["faults"] > 0
        _assert_reclaimed(engine)
        _probe(engine)
        _assert_reclaimed(engine)
    finally:
        engine.stop()


def test_plan_fault_fails_the_rows_in_flight_and_keeps_serving(model):
    """A ``sched.plan`` fault is a failed step: the rows in flight fail
    with the fault, the queue survives and the engine serves on."""
    engine = make_engine(model)
    inj = chaos.ChaosInjector(7, {"sched.plan": 1.0}, max_faults=1)
    fut = engine.submit("first", max_new_tokens=30)
    with chaos.active(inj):
        engine.start()
        try:
            assert _settle(fut) in ("ChaosFault", "stop", "length")
            _probe(engine)
        finally:
            engine.stop()
    assert inj.stats()["sched.plan"]["faults"] == 1


def test_kv_alloc_fault_requeues_an_admission(model):
    """``kv.alloc`` raises the pool's own OutOfBlocks at admission: the
    request goes back to the head of its class and is served."""
    engine = make_engine(model, kv_layout="paged", kv_page_size=8)
    inj = chaos.ChaosInjector(11, {"kv.alloc": 1.0}, max_faults=2)
    with chaos.active(inj):
        engine.start()
        try:
            res = engine.submit("needs pages", max_new_tokens=4).result(timeout=60)
        finally:
            engine.stop()
    assert res.finish_reason in ("stop", "length")
    assert inj.stats()["kv.alloc"]["faults"] == 2


def test_spill_fault_drops_the_entry_to_a_miss():
    cache = TieredPrefixCache(1, spill_bytes=1 << 20, device="cpu")
    with chaos.active(chaos.ChaosInjector(101, {"kv.spill": 1.0})):
        cache.put("a", (torch.zeros(4),))
        cache.put("b", (torch.zeros(4),))  # evicts "a": its spill faults
        assert cache.flush(5.0)
    assert cache.stats()["host"]["entries"] == 0
    assert cache.stats()["spill_dropped_total"] == 1
    assert cache.get_with_tier("a") == (None, "miss")
    cache.close()


def test_lora_upload_fault_requeues_and_leaves_no_pin(model):
    """A faulted adapter upload is transient: admission sees AdapterBusy,
    the request requeues and is served with its adapter, with no pin left
    (the registry attaches its done callback outside its mutex, so an
    upload that fails at once cannot deadlock it)."""
    cfg, _ = model
    reg = AdapterRegistry(max_active=3, device="cpu")
    reg.register(make_adapter(cfg, "a", rank=2, seed=3, scale=4.0))
    engine = make_engine(model, lora=reg)
    inj = chaos.ChaosInjector(202, {"lora.upload": 1.0}, max_faults=2)
    try:
        with chaos.active(inj):
            engine.start()
            outcomes = [_settle(engine.submit(f"lora {i}", max_new_tokens=4, adapter_id="a"))
                        for i in range(3)]
        assert all(o in ("stop", "length") for o in outcomes), outcomes
        assert inj.stats()["lora.upload"]["faults"] == 2
        assert reg.residency()["upload_faults_total"] >= 1
        assert reg.residency()["pinned_slots"] == 0
        _assert_reclaimed(engine)
    finally:
        engine.stop()
        reg.close()


def test_acquire_pins_an_upload_that_ended_before_its_reread(model):
    """acquire() starts an upload that finishes, done callback and all,
    before acquire re-reads its future: the adapter is resident, so the
    port pins it (the reference raises AdapterBusy there; ROADMAP Queue C
    item 12)."""
    cfg, _ = model
    reg = AdapterRegistry(max_active=3, device="cpu")
    reg.register(make_adapter(cfg, "a", rank=2, seed=3, scale=4.0))
    real = reg.prefetch

    def prefetch_to_the_end(adapter_id):
        real(adapter_id)
        t_end = time.monotonic() + 10
        while adapter_id in reg._uploads and time.monotonic() < t_end:
            time.sleep(0.001)
        assert adapter_id not in reg._uploads

    reg.prefetch = prefetch_to_the_end
    try:
        slot = reg.acquire("a", timeout=5.0)
        assert slot >= 1 and reg.residency()["pinned_slots"] == 1
        reg.release(slot)
    finally:
        reg.close()


def test_tenant_preempt_fault_skips_the_preemption(model):
    """A faulted preemption is a skipped one: the ladder tries again while
    the pressure lasts, the interactive requests finish, and every row of
    the batch-class flood reaches one terminal state."""
    tenants = TenantRegistry()
    tenants.set_policy(TenantPolicy(name="gold", deadline_class="interactive", deadline_s=60.0))
    tenants.set_policy(TenantPolicy(name="bulk", deadline_class="batch", deadline_s=120.0))
    engine = make_engine(model, tenants=tenants, prefix_cache_entries=16, prefill_chunk_tokens=8)
    inj = chaos.ChaosInjector(303, {"tenant.preempt": 0.5}, max_faults=3)
    preempt_calls = []
    real = engine._preempt

    def counting(slot):
        preempt_calls.append(slot)
        return real(slot)

    engine._preempt = counting
    engine.start()
    try:
        with chaos.active(inj):
            started = threading.Event()

            def on_token(token_id, piece, done):
                started.set()

            low = [engine.submit(f"low {i} xxxxxxxx"[:12], max_new_tokens=24, tenant="bulk",
                                 stream_cb=on_token if i == 0 else None) for i in range(5)]
            assert started.wait(30)  # the batch is full of the flood
            hi = [engine.submit(f"hi {i}", max_new_tokens=3, tenant="gold") for i in range(3)]
            for fut in hi:
                assert fut.result(timeout=60).finish_reason in ("stop", "length")
            outcomes = [_settle(f) for f in low]
        assert all(o in TERMINAL_REASONS for o in outcomes), outcomes
        assert preempt_calls and inj.stats()["tenant.preempt"]["calls"] == len(preempt_calls)
        _assert_reclaimed(engine)
    finally:
        engine.stop()
