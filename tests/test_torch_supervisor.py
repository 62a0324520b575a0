"""The port's engine supervision (``gofr_tpu_torch/serving/supervisor.py``)
on the CPU, mirroring the reference's ``tests/test_supervisor.py`` on the
port engine: watchdog detection, the warm restart, the budget that parks
the engine WEDGED, the poison storm, the compile grace and the quarantine
of a thread that cannot join; the watchdog's verdicts held against the
reference's supervisor on the same engine signals (exact reasons); and
device telemetry on an engine on the CPU.

Every wait is bounded (stall_s <= 0.5, join_timeout <= 0.5, hangs <= 2 s)
and waits on an event or a polled condition; every supervisor is halted in
a ``finally``. Seeds are fixed, as in the reference.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.serving.supervisor import EngineSupervisor as JEngineSupervisor  # noqa: E402
from gofr_tpu_torch import chaos  # noqa: E402
from gofr_tpu_torch.errors import (  # noqa: E402
    ErrorDeadlineExceeded,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.models import llama  # noqa: E402
from gofr_tpu_torch.serving import DeviceTelemetry, EngineSupervisor  # noqa: E402
from gofr_tpu_torch.serving import batch as batch_ops  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

CHAOS_SEEDS = (101, 202, 303)
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


class RecordingMetrics:
    def __init__(self) -> None:
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}

    def increment_counter(self, name, *labels, **kw) -> None:
        self.counters[name] = self.counters.get(name, 0) + 1

    def set_gauge(self, name, value, *labels, **kw) -> None:
        self.gauges[name] = value


@pytest.fixture(scope="module")
def model():
    # the reference's supervisor size, with a vocabulary that holds every
    # byte token (the port refuses ids past it)
    cfg = llama.LlamaConfig(vocab_size=300, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64, max_seq_len=64, dtype=torch.float32)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def make_engine(model, **kw) -> ServingEngine:
    cfg, params = model
    conf = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16,), admission_per_step=2,
                max_queue=32)
    conf.update(kw)
    return ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size),
                         device="cpu")


def make_supervisor(engine, **kw) -> EngineSupervisor:
    defaults = dict(stall_s=0.5, poll_s=0.03, restart_budget=3, restart_reset_s=60.0,
                    join_timeout=0.4)
    defaults.update(kw)
    return EngineSupervisor(engine, **defaults)


def wait_for(cond, timeout: float = 30.0, msg: str = "") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(msg or "condition not reached in time")
        time.sleep(0.005)


def probe_until_served(engine: ServingEngine, timeout: float = 60.0):
    """A probe that lands in a RESTARTING window (503) or on a leftover
    fault is part of the storm, not a verdict on the healed engine."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            res = engine.submit("probe", max_new_tokens=2).result(timeout=timeout)
            assert res.finish_reason in TERMINAL_REASONS
            return res
        except (*TERMINAL_ERRORS, RuntimeError):
            if time.monotonic() > deadline:
                raise
            wait_for(lambda: not engine._restarting, timeout=timeout)


def assert_reclaimed(engine: ServingEngine) -> None:
    wait_for(lambda: all(s is None for s in engine.slots) and not engine._by_id,
             msg="slots/requests not reclaimed")
    if engine.paged_cache is not None and engine.paged_cache.k_pool is not None:
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"], stats
        assert stats["sequences"] == 0


def _outcome(fut, timeout: float = 60.0):
    try:
        return fut.result(timeout=timeout).finish_reason
    except TERMINAL_ERRORS as exc:
        return type(exc).__name__


# -- warm restart mechanics ---------------------------------------------------
def test_warm_restart_requeues_queued_requests(model):
    """Queued, never-prefilled requests survive the restart and complete on
    the rebuilt engine; the epoch moves on."""
    engine = make_engine(model)
    try:
        futs = [engine.submit(f"queued {i}", max_new_tokens=3) for i in range(3)]
        assert engine.warm_restart() is True
        assert engine.epoch == 2
        for f in futs:
            assert f.result(timeout=60).finish_reason in TERMINAL_REASONS
        assert_reclaimed(engine)
    finally:
        engine.stop()


def test_warm_restart_stands_down_for_drain(model):
    """drain() racing restarts resolves to exactly one winner."""
    engine = make_engine(model)
    engine.start()
    stop_flag = threading.Event()
    results = []

    def restart_loop():
        while not stop_flag.is_set():
            try:
                results.append(engine.warm_restart(join_timeout=0.5))
            except Exception as exc:  # would fail below
                results.append(exc)

    t = threading.Thread(target=restart_loop, daemon=True)
    t.start()
    try:
        wait_for(lambda: results, timeout=30, msg="no restart ran before the drain")
        assert engine.drain(deadline_s=30) is True
        stop_flag.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not any(isinstance(r, Exception) for r in results), results
        assert engine.warm_restart() is False  # the drain won: stand down
        assert engine.health_check()["status"] == "DOWN"
        assert engine._thread is None or not engine._thread.is_alive()
        with pytest.raises(ErrorServiceUnavailable):
            engine.submit("late", max_new_tokens=2)
    finally:
        stop_flag.set()
        if engine._running:
            engine.stop()


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_warm_restart_rebuild_failure_settles_requeued(model, kv_layout):
    """A rebuild that fails leaves the requeued requests only in
    warm_restart's own list: they settle retriable before the failure
    escapes."""
    engine = make_engine(model, kv_layout=kv_layout, kv_page_size=8)
    futs = [engine.submit(f"queued {i}", max_new_tokens=3) for i in range(2)]

    def broken_rebuild():
        raise RuntimeError("device still refusing allocations")

    setattr(engine, "_make_dense_cache" if kv_layout == "dense" else "_make_paged_cache",
            broken_rebuild)
    with pytest.raises(RuntimeError):
        engine.warm_restart()
    for f in futs:
        with pytest.raises(ErrorServiceUnavailable) as exc_info:
            f.result(timeout=10)
        assert exc_info.value.retry_after is not None
    assert not engine._restarting
    engine.stop()


def test_stand_down_clears_stale_restarting_state(model):
    """drain() winning the race mid-restart must not leave the supervisor
    at RESTARTING, which health ranks above the engine's own DOWN."""
    engine = make_engine(model)
    engine.start()
    sup = make_supervisor(engine)
    try:
        assert engine.drain(deadline_s=30) is True
        sup._transition("RESTARTING")  # the watchdog had claimed one
        sup._restart("stall detected just before the drain")
        assert sup.state == "UP"
        assert engine.health_check()["status"] == "DOWN"
        assert sup._stop.is_set()
    finally:
        sup.stop()


def test_supervisor_states_surface_in_health(model):
    engine = make_engine(model)
    sup = make_supervisor(engine)
    try:
        health = sup.health_check()
        assert health["details"]["supervisor"]["state"] == "UP"
        assert health["details"]["supervisor"] == sup.snapshot()
        for state in ("SUSPECT", "RESTARTING", "WEDGED"):
            sup.state = state
            engine._running = True  # pretend-live so the state alone decides
            assert engine.health_check()["status"] == state
        engine._running = False
        sup.state = "UP"
    finally:
        sup.stop()


def test_earn_back_resets_consecutive_restarts(model):
    engine = make_engine(model)
    sup = make_supervisor(engine, restart_reset_s=0.05)
    sup._consecutive = 2
    sup._last_restart_t = time.monotonic()
    sup.start()
    try:
        wait_for(lambda: sup._consecutive == 0, timeout=10,
                 msg="healthy run never earned the restart budget back")
    finally:
        sup.drain(deadline_s=30)


# -- watchdog detection under fixed-seed chaos --------------------------------
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_hang_is_detected_and_healed(model, seed):
    """An engine.step hang: the watchdog sees the stale heartbeat, warm-
    restarts (quarantining the hung thread), the queued requests complete,
    and app_engine_restarts_total counts it."""
    metrics = RecordingMetrics()
    engine = make_engine(model)
    sup = make_supervisor(engine, metrics=metrics, join_timeout=0.3)
    engine.start()
    try:
        engine.submit("warmup", max_new_tokens=3).result(timeout=60)
        inj = chaos.ChaosInjector(seed, {"engine.step": 1.0}, max_faults=1,
                                  fault_factories={"engine.step": chaos.hang_factory(1.2)})
        with chaos.active(inj):
            sup.start()  # the next loop iteration hangs 1.2 s > stall_s
            futs = [engine.submit(f"pre-hang {i}", max_new_tokens=3) for i in range(4)]
            for f in futs:
                assert f.result(timeout=60).finish_reason in TERMINAL_REASONS
            wait_for(lambda: sup.restarts >= 1, timeout=30,
                     msg="watchdog never restarted the hung engine")
        assert metrics.counters.get("app_engine_restarts_total", 0) >= 1
        assert inj.stats()["engine.step"]["faults"] == 1
        assert_reclaimed(engine)
    finally:
        sup.drain(deadline_s=30)
    assert engine.health_check()["status"] == "DOWN"


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_crash_is_detected_and_healed(model, seed):
    """engine.step raises past the per-step recovery: the loop thread
    dies, the watchdog reads loop_crashed and restarts, queued requests
    complete."""
    engine = make_engine(model)
    sup = make_supervisor(engine)
    futs = [engine.submit(f"pre-crash {i}", max_new_tokens=3) for i in range(3)]
    inj = chaos.ChaosInjector(seed, {"engine.step": 1.0}, max_faults=1)
    try:
        with chaos.active(inj):
            sup.start()
            for f in futs:
                assert f.result(timeout=60).finish_reason in TERMINAL_REASONS
            wait_for(lambda: sup.restarts >= 1, timeout=30,
                     msg="watchdog never restarted the crashed engine")
            assert sup.last_reason == "loop thread died"
            assert not engine.loop_crashed  # cleared by the restart
        assert_reclaimed(engine)
    finally:
        sup.drain(deadline_s=30)


def test_hung_thread_wedge_settles_queued_futures(model):
    """Budget exhaustion on a true hang: stop() cannot join the thread and
    takes the wedge path, which still settles every registered future
    retriable and reports WEDGED."""
    engine = make_engine(model)
    sup = make_supervisor(engine, stall_s=0.2, poll_s=0.05, restart_budget=1,
                          join_timeout=0.3)
    inj = chaos.ChaosInjector(11, {"engine.step": 1.0},
                              fault_factories={"engine.step": chaos.hang_factory(2.0)})
    try:
        with chaos.active(inj):
            sup.start()
            try:
                fut = engine.submit("queued behind the hang", max_new_tokens=2)
            except TERMINAL_ERRORS:
                fut = None  # raced a restart window: already terminal
            wait_for(lambda: sup.state == "WEDGED", timeout=30,
                     msg="supervisor did not park on a true hang")
            assert engine.health_check()["status"] == "WEDGED"
            if fut is not None:
                with pytest.raises(ErrorServiceUnavailable):
                    fut.result(timeout=10)
            assert not engine._by_id, "the wedge left requests registered"
            assert not engine._running
    finally:
        sup._stop.set()


def test_budget_exhaustion_parks_wedged(model):
    """Every restarted thread dies again: past the budget the supervisor
    parks the engine WEDGED, never flapping."""
    metrics = RecordingMetrics()
    engine = make_engine(model)
    sup = make_supervisor(engine, metrics=metrics, restart_budget=2)
    fut = engine.submit("doomed", max_new_tokens=3)
    inj = chaos.ChaosInjector(7, {"engine.step": 1.0})  # unbounded faults
    try:
        with chaos.active(inj):
            sup.start()
            wait_for(lambda: sup.state == "WEDGED", timeout=60,
                     msg="budget exhaustion never parked the engine")
            with pytest.raises(ErrorServiceUnavailable):
                fut.result(timeout=30)
            assert sup.restarts == 2
            assert engine.health_check()["status"] == "WEDGED"
            assert metrics.gauges.get("app_engine_supervisor_state") == 3.0
            sup._thread.join(timeout=10)
            assert not sup._thread.is_alive()  # parked: never flaps
            assert sup.state == "WEDGED" and sup.restarts == 2
            engine.stop(join_timeout=1.0)  # a second stop is harmless
            assert engine.health_check()["status"] == "WEDGED"
    finally:
        sup._stop.set()


def test_isolated_poisonings_decay_instead_of_restarting(model):
    """Only a poison storm restarts: an isolated poisoning followed by
    restart_reset_s of quiet rebases the mark, so a second one later is
    below the threshold again."""
    engine = make_engine(model)
    sup = make_supervisor(engine, poll_s=0.02, restart_reset_s=0.15, poison_threshold=2)
    sup.start()
    try:
        engine.device_poisonings += 1  # healed in place; the engine is healthy
        wait_for(lambda: sup._poison_mark == 1, timeout=10, msg="the mark never rebased")
        engine.device_poisonings += 1  # another isolated, healed fault
        wait_for(lambda: sup._poison_seen == 2, timeout=10, msg="watchdog never polled")
        assert sup.restarts == 0, "isolated poisonings must not restart"
        assert sup.state == "UP"
    finally:
        sup.stop()


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_device_poisoning_escalates_to_restart(model, seed):
    """Repeated device.loss poisonings escalate past the in-place rebuild
    to a warm restart; every submission reaches one terminal state and the
    healed engine serves."""
    engine = make_engine(model)
    sup = make_supervisor(engine, poison_threshold=2, restart_budget=5)
    inj = chaos.ChaosInjector(seed, {"device.loss": 1.0}, max_faults=3)
    try:
        with chaos.active(inj):
            sup.start()
            outcomes = []
            for i in range(6):
                try:
                    outcomes.append(engine.submit(f"poison {i}", max_new_tokens=3))
                except TERMINAL_ERRORS as exc:
                    outcomes.append(exc)
                wait_for(lambda: engine._sched.pending() == 0 or engine._restarting, timeout=30)
            wait_for(lambda: engine.device_poisonings >= 2, timeout=30,
                     msg="device.loss never poisoned the engine")
            wait_for(lambda: sup.restarts >= 1, timeout=30,
                     msg="poison storm never escalated to a restart")
            for item in outcomes:
                if not isinstance(item, BaseException):
                    assert _outcome(item) in TERMINAL_REASONS | {"DeviceLost",
                                                                 "ErrorServiceUnavailable"}
            probe_until_served(engine)
            assert not engine._kv_unhealthy()
        assert_reclaimed(engine)
    finally:
        sup.drain(deadline_s=30)


# -- compile grace and retired-thread containment -----------------------------
def test_cold_dispatch_marks_warmed_only_on_success(model):
    engine = make_engine(model)
    assert not engine.in_cold_dispatch
    with pytest.raises(RuntimeError):
        with engine._cold_dispatch("probe", 1):
            assert engine.in_cold_dispatch
            raise RuntimeError("faulted dispatch")
    assert not engine.in_cold_dispatch
    assert ("probe", 1) not in engine._warmed
    with engine._cold_dispatch("probe", 1):
        assert engine.in_cold_dispatch
    assert ("probe", 1) in engine._warmed
    with engine._cold_dispatch("probe", 1):  # warmed: no cold flag
        assert not engine.in_cold_dispatch
    engine.stop()


def test_first_slow_dispatch_is_not_a_stall(model, monkeypatch):
    """A first prefill that outlasts stall_s is a signature's first run
    (on the card: the kernel build), not a hang: the limit widens to
    compile_grace_s and the request completes with zero restarts; every
    dispatch kind it ran is warmed."""
    real = batch_ops.prefill_compute
    slowed = []

    def slow_first(*args, **kw):
        if not slowed:
            slowed.append(1)
            time.sleep(1.0)  # > stall_s, < compile_grace_s
        return real(*args, **kw)

    monkeypatch.setattr(batch_ops, "prefill_compute", slow_first)
    engine = make_engine(model)
    sup = make_supervisor(engine)
    assert sup.compile_grace_s > sup.stall_s
    try:
        sup.start()
        res = engine.submit("cold start", max_new_tokens=6).result(timeout=60)
        assert res.finish_reason in TERMINAL_REASONS
        assert sup.restarts == 0, "the first dispatch was misread as a stall"
        assert sup.state == "UP"
        assert ("prefill", 16, False) in engine._warmed
        if res.completion_tokens > 1:
            assert ("decode", "dense", False, 4, False) in engine._warmed
    finally:
        sup.stop()


def test_stall_inside_warmed_dispatch_heals_without_corruption(model, monkeypatch):
    """A stall inside a warmed prefill: one restart, the stalled request
    (never prefilled from the restart's view) requeues and completes, and
    the thawed thread unwinds through _check_retired instead of writing
    into the rebuilt pools."""
    engine = make_engine(model, kv_layout="paged", kv_page_size=8)
    sup = make_supervisor(engine, join_timeout=0.2)
    sup.start()
    try:
        engine.submit("warmup", max_new_tokens=3).result(timeout=60)
        real = batch_ops.prefill_compute
        stalled = threading.Event()

        def stall_once(*args, **kw):
            if not stalled.is_set():
                stalled.set()
                time.sleep(1.5)  # > stall_s, > join_timeout: the quarantine path
            return real(*args, **kw)

        monkeypatch.setattr(batch_ops, "prefill_compute", stall_once)
        old_thread = engine._thread
        res = engine.submit("stalls mid-pre", max_new_tokens=4).result(timeout=60)
        assert res.finish_reason in TERMINAL_REASONS
        wait_for(lambda: sup.restarts >= 1, timeout=30, msg="the stall was never seen")
        old_thread.join(timeout=10)
        assert not old_thread.is_alive()
        assert sup.restarts == 1, "containment failed: the restart cascaded"
        probe_until_served(engine)
        assert sup.state == "UP"
        assert_reclaimed(engine)
    finally:
        sup.stop()


def test_thawed_thread_skips_doomed_iteration(model):
    """A hang that thaws while warm_restart waits in join(): the old thread
    re-checks _running before admitting, so the queued request is requeued
    and completes instead of failing retriable."""
    engine = make_engine(model)
    sup = make_supervisor(engine, stall_s=0.25, join_timeout=0.5)
    engine.start()
    try:
        engine.submit("warmup", max_new_tokens=3).result(timeout=60)
        inj = chaos.ChaosInjector(101, {"engine.step": 1.0}, max_faults=1,
                                  fault_factories={"engine.step": chaos.hang_factory(0.6)})
        with chaos.active(inj):
            sup.start()
            fut = engine.submit("queued through the hang", max_new_tokens=3)
            assert fut.result(timeout=60).finish_reason in TERMINAL_REASONS
            wait_for(lambda: sup.restarts >= 1, timeout=30, msg="hang never detected")
        assert engine._thread is not None and engine._thread.is_alive()
        assert_reclaimed(engine)
    finally:
        sup.drain(deadline_s=30)


# -- the watchdog's verdicts against the reference's ----------------------------
class _Signals:
    """The engine surface the watchdog reads, set by hand."""

    _metrics = None
    _logger = None

    def __init__(self, **kw) -> None:
        self.loop_crashed = False
        self._running = True
        self._draining = self._stop_requested = self._wedged = False
        self.device_poisonings = 0
        self.in_cold_dispatch = False
        self.age = 0.0
        self._supervisor = None
        self.__dict__.update(kw)

    def heartbeat_age(self) -> float:
        return self.age


VERDICTS = {
    "healthy": dict(),
    "crashed": dict(loop_crashed=True),
    "stale": dict(age=0.75),
    "stale-in-cold-dispatch": dict(age=0.75, in_cold_dispatch=True),
    "cold-past-grace": dict(age=3.5, in_cold_dispatch=True),
    "poisoned-at-threshold": dict(device_poisonings=2),
    "poisoned-below-threshold": dict(device_poisonings=1),
    "stopped": dict(_running=False, age=9.0),
}


@pytest.mark.parametrize("signals", sorted(VERDICTS))
def test_detect_reads_signals_as_the_reference_does(signals):
    """The same engine signals give the same SUSPECT reason (or none) on
    both supervisors, string for string."""
    reasons = []
    for cls in (EngineSupervisor, JEngineSupervisor):
        engine = _Signals()
        sup = cls(engine, stall_s=0.5, compile_grace_s=3.0, poison_threshold=2)
        engine.__dict__.update(VERDICTS[signals])
        reasons.append(sup._detect())
    assert reasons[0] == reasons[1]
    assert (reasons[0] is None) == (signals in ("healthy", "stale-in-cold-dispatch",
                                                 "poisoned-below-threshold", "stopped"))


# -- device telemetry -----------------------------------------------------------
def test_device_telemetry_on_the_cpu(model):
    """An engine on the CPU reports no devices; the duty cycle is the loop's
    busy share over the poll window, within [0, 1]; the sample rides
    health_check's details."""
    metrics = RecordingMetrics()
    engine = make_engine(model)
    tel = DeviceTelemetry(engine, metrics=metrics, interval_s=0.1)
    engine.start()
    try:
        tel.start()
        res = engine.submit("busy", max_new_tokens=4).result(timeout=60)
        assert res.finish_reason in TERMINAL_REASONS
        assert engine.busy_seconds() > 0
        sample = tel.sample()
        assert sample["devices"] == []
        assert 0.0 <= sample["engine_duty_cycle"] <= 1.0
        assert tel.hbm_headroom() is None
        assert 0.0 <= metrics.gauges["app_engine_duty_cycle"] <= 1.0
        assert engine.health_check()["details"]["device"]["devices"] == []
    finally:
        tel.stop()
        engine.stop()
