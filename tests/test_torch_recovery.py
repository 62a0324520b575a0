"""The port engine's recovery against the JAX ServingEngine, on the CPU at
the reference's supervisor size (two layers, d_model 32, f32; the JAX
package's ``init_params(PRNGKey(0))`` carried across), each side on an
engine of its own, the Pallas paths in interpret mode:

- a warm restart before start: queued greedy requests give the JAX
  engine's tokens and a clean port run's, a sampled one a clean port
  run's (per-seed determinism), and the epoch is 2 on both;
- a decode dispatch that hangs (both layouts): the request in flight fails
  with a retriable 503, the old scheduler is quarantine-leaked, a fresh
  request gives equal tokens, and the thawed thread exits with its slots
  and pages reclaimed;
- ``device.loss`` on four cache layouts: the request fails with
  ``DeviceLost``, one poisoning is counted, the rebuilt KV is healthy, and
  the next request's greedy tokens are equal;
- ``health_check``: the same status in each state driven on both engines,
  and the same details on the shared keys.

Tokens and statuses are held exactly. A poisoned (0-element) cache makes
each of the three kernel wrappers, and the dense reads, raise on the host.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu.http import errors as jerrors  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import batch as jbatch  # noqa: E402
from gofr_tpu.serving.lora import AdapterRegistry as JAdapterRegistry  # noqa: E402
from gofr_tpu.serving.lora import make_adapter as jmake_adapter  # noqa: E402
from gofr_tpu.serving.tenancy import TenantPolicy as JTenantPolicy  # noqa: E402
from gofr_tpu.serving.tenancy import TenantRegistry as JTenantRegistry  # noqa: E402
from gofr_tpu_torch import chaos  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from gofr_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_decode_attention_q,
)
from gofr_tpu_torch.serving import AdapterRegistry, TenantPolicy, TenantRegistry  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving import make_adapter  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16,), admission_per_step=2,
            max_queue=32, kv_page_size=8)
LAYOUTS = {
    "dense-bf16": dict(kv_layout="dense", kv_dtype="bf16"),
    "dense-int8": dict(kv_layout="dense", kv_dtype="int8"),
    "paged-bf16": dict(kv_layout="paged", kv_dtype="bf16"),
    "paged-int8": dict(kv_layout="paged", kv_dtype="int8"),
}
SIZE = dict(vocab_size=300, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
            max_seq_len=64)
# keys of the reference's health details whose planes the port has not yet
HEALTH_WAITING = {"dedup", "reclaim", "preemptible"}


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
    jcfg = jllama.LlamaConfig.tiny(**SIZE)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(**SIZE)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def _jax(models, layout="dense-bf16", lora=None, tenants=None, **kw):
    jcfg, jparams, _, _ = models
    conf = {**BASE, **LAYOUTS[layout], **kw}
    return JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer(jcfg.vocab_size),
                          lora=lora, tenants=tenants)


def _port(models, layout="dense-bf16", lora=None, tenants=None, **kw):
    _, _, tcfg, tparams = models
    conf = {**BASE, **LAYOUTS[layout], **kw}
    return ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(tcfg.vocab_size),
                         device="cpu", lora=lora, tenants=tenants)


def wait_for(cond, timeout: float = 30.0, msg: str = "") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(msg or "condition not reached in time")
        time.sleep(0.005)


def _assert_reclaimed(engine) -> None:
    wait_for(lambda: all(s is None for s in engine.slots) and not engine._by_id,
             msg="slots/requests not reclaimed")
    if engine.paged_cache is not None:
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"] and stats["sequences"] == 0, stats


def _tokens(fut, timeout: float = 60.0) -> tuple:
    r = fut.result(timeout=timeout)
    return r.finish_reason, r.token_ids


QUEUED = ["queued zero", "queued one", "queued two"]


# -------------------------------------------------------------- warm restart
def test_warm_restart_before_start_requeues_with_equal_tokens(models):
    """Three greedy requests and one sampled request queue on an engine not
    yet started; warm_restart() requeues them in order and they complete on
    the rebuilt engine with the JAX engine's greedy tokens, and with a clean
    port run's tokens, the sampled one included."""
    runs = {}
    for name, make, restart in (("jax", _jax, True), ("port", _port, True),
                                ("clean", _port, False)):
        engine = make(models)
        try:
            futs = [engine.submit(p, max_new_tokens=8) for p in QUEUED]
            futs.append(engine.submit("sampled", max_new_tokens=8, temperature=0.9, top_k=20))
            if restart:
                assert engine.warm_restart() is True
                assert engine.epoch == 2
            else:
                engine.start()
            runs[name] = [_tokens(f) for f in futs]
            _assert_reclaimed(engine)
        finally:
            engine.stop()
    assert runs["port"][:3] == runs["jax"][:3]
    assert runs["port"] == runs["clean"]


# ------------------------------------------------------- a hung decode dispatch
@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_hung_decode_dispatch_is_quarantined(models, monkeypatch, kv_layout):
    """The decode dispatch pins the engine thread; warm_restart cannot join
    it, quarantine-leaks the scheduler, fails the request in flight with a
    retriable 503 and serves a fresh request with the JAX engine's tokens;
    the thawed thread retires itself and every slot and page comes back."""
    layout = f"{kv_layout}-bf16"
    name = "decode_block" if kv_layout == "dense" else "decode_block_paged"
    outs = []
    for make, module, errors in ((_jax, jbatch, jerrors), (_port, tbatch, terrors)):
        hold, pinned = threading.Event(), threading.Event()
        real = getattr(module, name)

        def hanging(*args, _real=real, **kw):
            if not pinned.is_set():
                pinned.set()
                hold.wait(30)  # pins the engine thread mid-dispatch
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, hanging)
        engine = make(models, layout)
        engine.start()
        try:
            fut = engine.submit("held in flight", max_new_tokens=40)
            assert pinned.wait(30)
            old_thread, old_sched = engine._thread, engine._sched
            assert engine.warm_restart(join_timeout=0.2) is True
            assert old_thread.is_alive()  # hung: quarantined, not joined
            assert old_sched._closed  # leaked: closed, never reused
            with pytest.raises(errors.ErrorServiceUnavailable) as exc_info:
                fut.result(timeout=10)
            assert exc_info.value.retry_after is not None
            fresh = _tokens(engine.submit("fresh request", max_new_tokens=8))
            hold.set()  # thaw: the identity guard retires the old thread
            old_thread.join(timeout=10)
            assert not old_thread.is_alive()
            assert engine._thread is not old_thread and engine._thread.is_alive()
            _assert_reclaimed(engine)
            outs.append(fresh)
        finally:
            hold.set()
            engine.stop()
    assert outs[1] == outs[0]


# ------------------------------------------------------------- device loss
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_device_loss_rebuilds_in_place(models, layout):
    """``device.loss`` fires at the first decode dispatch: the KV storage is
    poisoned, the request fails with DeviceLost, one poisoning is counted,
    the rebuilt storage is healthy, and the next request's greedy tokens
    are the JAX engine's."""
    outs = []
    for make, module in ((_jax, jchaos), (_port, chaos)):
        engine = make(models, layout)
        engine.start()
        try:
            inj = module.ChaosInjector(101, {"device.loss": 1.0}, max_faults=1)
            with module.active(inj):
                with pytest.raises(module.DeviceLost):
                    engine.submit("doomed prompt", max_new_tokens=8).result(timeout=60)
            assert engine.device_poisonings == 1
            wait_for(lambda: not engine._kv_unhealthy(), timeout=10)
            outs.append(_tokens(engine.submit("after the loss", max_new_tokens=8)))
            _assert_reclaimed(engine)
        finally:
            engine.stop()
    assert outs[1] == outs[0]


# ------------------------------------------------------------ health_check
def _registries(models, jax_side: bool):
    """A one-adapter registry and two tenant classes, on either side."""
    jcfg, _, tcfg, _ = models
    if jax_side:
        reg = JAdapterRegistry(max_active=3)
        reg.register(jmake_adapter(jcfg, "a", rank=2, seed=3, scale=4.0))
        tenants = JTenantRegistry()
        policy = JTenantPolicy
    else:
        reg = AdapterRegistry(max_active=3, device="cpu")
        reg.register(make_adapter(tcfg, "a", rank=2, seed=3, scale=4.0))
        tenants = TenantRegistry()
        policy = TenantPolicy
    tenants.set_policy(policy(name="gold", deadline_class="interactive", deadline_s=60.0))
    tenants.set_policy(policy(name="bulk", deadline_class="batch", deadline_s=120.0))
    return reg, tenants


def _shared_details(port: dict, ref: dict) -> tuple[dict, dict]:
    """The details both engines report, less wall-clock values: the
    heartbeat age, the shed estimator's EWMAs (seconds), the latency
    medians of ``request_latency`` (its keys and counts are held) and the
    reference's keys whose planes are not ported; the scheduler is the
    reference's Python one in the port."""
    assert set(ref) - set(port) <= HEALTH_WAITING, set(ref) - set(port)
    assert set(port) <= set(ref), set(port) - set(ref)
    assert port["scheduler_backend"] == "python"
    out = []
    for details in (port, ref):
        d = {k: v for k, v in details.items()
             if k not in ("heartbeat_age_s", "scheduler_backend") and k in port}
        d["shed"] = {"keys": sorted(d["shed"]), "cold_prior_s": d["shed"]["cold_prior_s"]}
        lat = d["request_latency"]
        d["request_latency"] = {"keys": sorted(lat), "in_flight": lat["in_flight"],
                                "completed": lat["completed"]}
        out.append(d)
    return out[0], out[1]


def _pin_decode(monkeypatch, module, name):
    hold, pinned = threading.Event(), threading.Event()
    real = getattr(module, name)

    def hanging(*args, **kw):
        if not pinned.is_set():
            pinned.set()
            hold.wait(30)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, hanging)
    return hold, pinned


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_health_statuses_and_details_match(models, monkeypatch, kv_layout):
    """UP with equal details after a request; RESTARTING while warm_restart
    holds; UP again; DRAINING during a drain; DOWN after it; then a second
    engine pair: WEDGED after a stop that cannot join, DOWN after a stop
    that joins."""
    layout = f"{kv_layout}-bf16"
    name = "decode_block" if kv_layout == "dense" else "decode_block_paged"
    seen, details = [], []
    for jax_side, make, module in ((True, _jax, jbatch), (False, _port, tbatch)):
        reg, tenants = _registries(models, jax_side)
        statuses = []
        engine = make(models, layout, prefix_cache_entries=8, lora=reg, tenants=tenants)
        try:
            engine.start()
            assert _tokens(engine.submit("health probe", max_new_tokens=4))[0] in ("stop",
                                                                                   "length")
            _assert_reclaimed(engine)
            health = engine.health_check()
            statuses.append(health["status"])
            details.append(health["details"])
            # RESTARTING while warm_restart holds in its rebuild
            entered, release = threading.Event(), threading.Event()
            real_init = engine._init_runtime_state

            def held_init(_real=real_init):
                entered.set()
                release.wait(30)
                _real()

            engine._init_runtime_state = held_init
            t = threading.Thread(target=engine.warm_restart, kwargs={"join_timeout": 5.0})
            t.start()
            assert entered.wait(30)
            statuses.append(engine.health_check()["status"])
            release.set()
            t.join(timeout=30)
            assert not t.is_alive()
            statuses.append(engine.health_check()["status"])
            # DRAINING while a decode dispatch is pinned, DOWN after
            hold, pinned = _pin_decode(monkeypatch, module, name)
            fut = engine.submit("drained", max_new_tokens=6)
            assert pinned.wait(30)
            drainer = threading.Thread(target=engine.drain, kwargs={"deadline_s": 30})
            drainer.start()
            wait_for(lambda: engine.draining, timeout=10)
            statuses.append(engine.health_check()["status"])
            hold.set()
            drainer.join(timeout=30)
            assert not drainer.is_alive()
            assert _tokens(fut)[0] in ("stop", "length")
            statuses.append(engine.health_check()["status"])
            monkeypatch.undo()
            # a second engine: WEDGED after a stop that cannot join
            engine = make(models, layout)
            hold, pinned = _pin_decode(monkeypatch, module, name)
            engine.start()
            fut = engine.submit("wedged", max_new_tokens=6)
            assert pinned.wait(30)
            engine.stop(join_timeout=0.2)
            statuses.append(engine.health_check()["status"])
            with pytest.raises(Exception) as exc_info:
                fut.result(timeout=10)
            assert getattr(exc_info.value, "status_code", None) == 503
            hold.set()
            engine.stop(join_timeout=10)  # joins now
            statuses.append(engine.health_check()["status"])
            monkeypatch.undo()
        finally:
            engine.stop()
            reg.close()
        seen.append(statuses)
    assert seen[0] == ["UP", "RESTARTING", "UP", "DRAINING", "DOWN", "WEDGED", "DOWN"]
    assert seen[1] == seen[0]
    port, ref = _shared_details(details[1], details[0])
    assert port == ref


# ------------------------------------------------- poisoned KV on the host
def test_poisoned_kv_raises_on_the_host_before_any_launch(models):
    """0-element pools and caches (the port's poison) are refused by each
    kernel wrapper on any device, and the dense decode's reads fail their
    shape checks; _kv_unhealthy reports both layouts."""
    gen = torch.Generator().manual_seed(1)
    launches = (paged_decode_attention.launches, paged_decode_attention_q.launches,
                flash_attention.launches)
    q = torch.randn(2, 4, 8, generator=gen)
    empty = torch.empty(0)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="0-element"):
        paged_decode_attention(q, empty, empty, tables, lens)
    with pytest.raises(ValueError, match="0-element"):
        paged_decode_attention_q(q, empty.to(torch.int8), empty.to(torch.int8), empty, empty,
                                 tables, lens)
    qf = torch.randn(1, 4, 4, 8, generator=gen)
    with pytest.raises(ValueError, match="0-element"):
        flash_attention(qf, empty, empty)
    with pytest.raises(ValueError, match="0-element"):
        flash_attention(qf, torch.empty(1, 0, 2, 8), torch.empty(1, 0, 2, 8))
    assert launches == (paged_decode_attention.launches, paged_decode_attention_q.launches,
                        flash_attention.launches)
    _, _, tcfg, tparams = models
    for layout in sorted(LAYOUTS):
        engine = _port(models, layout)
        assert not engine._kv_unhealthy()
        engine._poison_device()
        assert engine._kv_unhealthy()
        if engine.cache is not None:
            cache = engine.cache
            assert all(t is None or t.numel() == 0 for t in cache.tensors())
            state = tbatch.make_decode_state(
                np.array([5, 7]), np.array([4, 4], np.int32), np.zeros(2, bool),
                np.array([8, 8], np.int32), np.array([-1, -1]), np.ones(2, np.float32),
                np.zeros(2), np.ones(2, np.float32), torch.Generator().manual_seed(0),
                np.zeros(2, np.int32), device=torch.device("cpu"))
            with pytest.raises((ValueError, IndexError, RuntimeError)):
                tbatch.decode_block(tcfg, tparams, cache, state, torch.ones(2, dtype=torch.bool),
                                    2)
        else:
            assert all(t is None or t.numel() == 0 for t in engine.paged_cache.pools())
        engine._rebuild_kv()
        assert not engine._kv_unhealthy()
        engine.stop()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rebuilds_release_the_old_kv_first(models, monkeypatch, layout):
    """The in-place rebuild and warm_restart drop the engine's reference to
    the old KV storage before the new one is allocated (on the card a
    cache sized to fill it is rebuilt without holding two)."""
    engine = _port(models, layout)
    seen = []
    if engine.paged_cache is not None:
        pc = engine.paged_cache
        old = [t for t in pc.pools() if t is not None]
        real_zeros = torch.zeros

        def zeros(*args, **kw):
            seen.append(not any(t is o for t in pc.pools() for o in old))
            return real_zeros(*args, **kw)

        monkeypatch.setattr(torch, "zeros", zeros)
        engine._rebuild_kv()
        monkeypatch.setattr(torch, "zeros", real_zeros)
        real_make = engine._make_paged_cache
    else:
        real_make = engine._make_dense_cache
    name = "_make_paged_cache" if engine.paged_cache is not None else "_make_dense_cache"

    def make():
        seen.append(engine.cache is None and engine.paged_cache is None)
        return real_make()

    setattr(engine, name, make)
    if engine.cache is not None:
        engine._rebuild_kv()
    assert engine.warm_restart() is True
    try:
        assert seen and all(seen), seen
        assert not engine._kv_unhealthy()
    finally:
        engine.stop()


def test_out_of_vocabulary_prompt_is_refused(models):
    """A prompt id past the vocabulary is a 400 at submit: on the card the
    embedding gather would be a device-side assert, which no restart
    heals (the reference's gather clamps it)."""
    engine = _port(models)
    try:
        with pytest.raises(terrors.ErrorInvalidParam):
            engine.submit([1, 5, SIZE["vocab_size"]], max_new_tokens=2)
        with pytest.raises(terrors.ErrorInvalidParam):
            engine.submit([1, -1], max_new_tokens=2)
        assert not engine._by_id
    finally:
        engine.stop()
