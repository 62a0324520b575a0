"""Deterministic, seed-driven fault injection (the chaos tier); a copy of
``gofr_tpu/chaos/injector.py`` (the port imports nothing of the JAX
package), with the port's own fault types behind the defaults.

Named injection points sit at the seams where production faults arrive
(the scheduler boundary, the step plan, decode dispatch, paged-KV
allocation, the spill and adapter-upload workers, the preemption ladder,
the top of the engine loop); a :class:`ChaosInjector` decides per call,
from a fixed seed, whether that call fails. Same seed, same fault
schedule, every run, regardless of wall clock: each point draws from its
own ``random.Random`` stream keyed by ``(seed, point)`` and a per-point
call counter, so schedules are reproducible even when threads interleave
differently. ``POINTS`` is the reference's tuple, so a schedule names the
same points in both packages; the points whose modules are not ported yet
fire nowhere in the port.

The port's injector is a global of its own: installing one in this
package arms nothing in the JAX package, and the other way round.
Production cost is one module-global ``is None`` check per injection
point.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Any, Callable

# The registered injection points. Hooks call ``maybe_fail`` with one of
# these names; installing an injector with an unknown point name raises so
# a typo'd schedule cannot silently test nothing.
POINTS = (
    "sched.submit",     # native-scheduler boundary: request queueing
    "sched.admit",      # native-scheduler boundary: batch admission
    "sched.plan",       # step-plan assembly (continuous-batching policy)
    "decode.dispatch",  # engine decode dispatch (device step)
    "engine.step",      # top of the engine loop iteration (raise AND hang)
    "device.loss",      # device/executable poisoning (persistent KV dies)
    "kv.alloc",         # paged-KV pool allocation / extension
    "kv.spill",         # host-RAM spill worker (device→host copy drops)
    "kv.migrate",       # cross-replica KV page fetch (source dies mid-transfer)
    "kv.handoff",       # prefill→decode KV handoff fetch (source/transport dies)
    "service.request",  # outbound HTTP service client
    "pubsub.publish",   # pubsub publish
    "pubsub.subscribe",  # consumer-loop poll (broker fetch)
    "pubsub.ack",       # message settlement (commit / nack)
    "pubsub.handler",   # subscriber handler invocation
    "router.route",     # router submission to a replica (transport seam)
    "router.heartbeat",  # replica heartbeat publish (partition: beat drops)
    "stream.remote",    # remote token-stream transport (tears mid-stream)
    "scale.decision",   # autoscaler control-loop decision (skipped round)
    "tenant.preempt",   # preemption ladder (faulted = skipped, advisory)
    "lora.upload",      # async adapter upload (faulted = requeue, transient)
    "replica.reclaim",  # reclamation-notice delivery (faulted = notice lost)
    "kv.evacuate",      # reclaim-side bulk KV push (source dies mid-push)
    "router.claim",     # idempotency fast-path lookup (faulted = cold walk)
    "stream.resume",    # keyed re-attach admission (faulted = retriable)
)


class ChaosFault(RuntimeError):
    """The generic injected fault: a transient, retriable infrastructure
    error (transport reset, RPC deadline, broker hiccup)."""

    retriable = True

    def __init__(self, point: str, nth_call: int) -> None:
        super().__init__(f"injected chaos fault at {point} (call #{nth_call})")
        self.point = point
        self.nth_call = nth_call


class DeviceLost(ChaosFault):
    """Injected device loss: the accelerator (or its compiled executable)
    died under the engine. Unlike the generic transient, the engine's
    hook POISONS the persistent KV buffers before this propagates, so
    recovery must rebuild device state, not just retry."""

    retriable = False


def hang_factory(seconds: float) -> Callable[[str, int], None]:
    """Fault factory for the HANG variant: instead of raising, the faulted
    call stalls for ``seconds`` on the calling thread and then proceeds
    normally (returns None → ``fire`` raises nothing). At ``engine.step``
    this freezes the decode loop the way a dispatch that never returns
    does — the watchdog must catch it through heartbeat age, because no
    exception will ever surface."""

    def factory(point: str, nth_call: int) -> None:
        time.sleep(seconds)  # the hang IS the injected fault
        return None

    return factory


def _default_fault_factories() -> dict[str, Callable[[str, int], BaseException]]:
    """Per-point defaults matching what the real seam raises: the KV pool
    raises OutOfBlocks (a transient the engine requeues on), the scheduler
    queue raises QueueFull (backpressure), everything else a transport-ish
    ChaosFault."""
    from gofr_tpu_torch.serving.kv_cache import OutOfBlocks
    from gofr_tpu_torch.serving.scheduler import QueueFull

    return {
        "kv.alloc": lambda p, n: OutOfBlocks(f"injected pool exhaustion at {p} (call #{n})"),
        "sched.submit": lambda p, n: QueueFull(f"injected queue-full at {p} (call #{n})"),
        "device.loss": DeviceLost,
    }


@dataclasses.dataclass(frozen=True)
class ScheduledFault:
    """One wall-clock-scheduled fault window, relative to the schedule's
    armed epoch. ``duration_s == 0`` is a latched one-shot: the FIRST call
    to the point at or after ``at_s`` faults, however late it arrives (a
    quiet point must not dodge its fault because no call landed in an
    instantaneous window). ``duration_s > 0`` faults calls inside
    ``[at_s, at_s + duration_s)`` with probability ``rate`` (drawn from the
    schedule's own seeded stream), capped at ``max_faults`` fires
    (``None`` = every matching call)."""

    point: str
    at_s: float
    duration_s: float = 0.0
    rate: float = 1.0
    max_faults: int | None = 1
    # optional override of the injector's per-point factory for this
    # window (e.g. hang_factory for a scheduled heartbeat partition)
    factory: Callable[[str, int], BaseException | None] | None = None


class FaultSchedule:
    """Deterministic wall-clock fault plan: faults at known offsets, not
    per-call probabilities. Complements :class:`ChaosInjector`'s
    probability rates — a schedule says "kill the replica 3 s in, partition
    heartbeats from 5 s to 7 s", which per-call coin flips cannot express.
    ``arm()`` pins the epoch (``install`` arms automatically); offsets are
    then measured on the monotonic clock, so the schedule is deterministic
    in TIME — same seed and same run shape reproduce the same fault
    windows, even though thread interleaving varies which exact call in a
    window draws the fault."""

    def __init__(self, faults: list[ScheduledFault] | tuple[ScheduledFault, ...],
                 *, seed: int = 0) -> None:
        unknown = {f.point for f in faults} - set(POINTS)
        if unknown:
            raise ValueError(f"unknown chaos point(s) in schedule: {sorted(unknown)}")
        self.seed = seed
        self.faults = tuple(sorted(faults, key=lambda f: (f.at_s, f.point)))
        self._mu = threading.Lock()
        self._epoch: float | None = None
        self._fired = [0] * len(self.faults)
        self._rngs = [
            random.Random(f"sched:{seed}:{f.point}:{i}")
            for i, f in enumerate(self.faults)
        ]

    @property
    def armed(self) -> bool:
        return self._epoch is not None

    def arm(self, epoch: float | None = None) -> None:
        """Pin t=0 (monotonic seconds). Idempotent on re-arm with an
        explicit epoch; a bare re-arm keeps the first epoch so ``install``
        cannot silently shift a caller-armed schedule."""
        with self._mu:
            if epoch is not None:
                self._epoch = epoch
            elif self._epoch is None:
                self._epoch = time.monotonic()

    def points(self) -> set[str]:
        return {f.point for f in self.faults}

    def claim(self, point: str, now: float | None = None) -> ScheduledFault | None:
        """Return the scheduled fault that claims a call at ``point`` right
        now, consuming one fire from its budget — or None. Unarmed
        schedules never fire (no surprise faults before t=0 exists)."""
        with self._mu:
            if self._epoch is None:
                return None
            t = (time.monotonic() if now is None else now) - self._epoch
            for i, f in enumerate(self.faults):
                if f.point != point or t < f.at_s:
                    continue
                if f.max_faults is not None and self._fired[i] >= f.max_faults:
                    continue
                if f.duration_s > 0.0:
                    if t >= f.at_s + f.duration_s:
                        continue
                    if f.rate < 1.0 and self._rngs[i].random() >= f.rate:
                        continue
                # duration 0: latched one-shot — first call at/after at_s
                self._fired[i] += 1
                return f
        return None

    def stats(self) -> list[dict[str, Any]]:
        with self._mu:
            return [
                {
                    "point": f.point, "at_s": f.at_s,
                    "duration_s": f.duration_s, "fired": self._fired[i],
                }
                for i, f in enumerate(self.faults)
            ]

    @classmethod
    def seeded(cls, seed: int, horizon_s: float, points: list[str] | tuple[str, ...],
               *, per_point: int = 1, duration_s: float = 0.0,
               rate: float = 1.0, max_faults: int | None = 1) -> "FaultSchedule":
        """Seed-derived offsets: ``per_point`` windows per point, placed
        uniformly in ``[0, horizon_s)`` by a stream keyed on the seed alone
        — same seed, same offsets, every run."""
        rng = random.Random(f"faultsched:{seed}")
        faults = [
            ScheduledFault(p, at_s=rng.random() * horizon_s,
                           duration_s=duration_s, rate=rate,
                           max_faults=max_faults)
            for p in points
            for _ in range(per_point)
        ]
        return cls(faults, seed=seed)


class ChaosInjector:
    """Seed-driven fault schedule over the registered injection points.

    ``rates`` maps point name → fault probability per call. ``max_faults``
    (per point) bounds how many times a point fires, which guarantees the
    system under test converges — after the budget is spent the point goes
    quiet and retries/requeues succeed. A fault factory normally returns
    the exception to raise; one that returns ``None`` performs its fault
    in-line instead (``hang_factory`` stalls the calling thread) and the
    faulted call then proceeds.

    ``schedule`` composes a wall-clock :class:`FaultSchedule` with the
    probability rates: a call is first offered to the schedule (faults at
    known offsets), then to the per-call coin flip. Scheduled fires keep
    their own budget and do NOT consume ``max_faults``.
    """

    def __init__(
        self,
        seed: int,
        rates: dict[str, float],
        *,
        max_faults: int | None = None,
        fault_factories: dict[str, Callable[[str, int], BaseException]] | None = None,
        schedule: FaultSchedule | None = None,
    ) -> None:
        unknown = set(rates) - set(POINTS)
        if unknown:
            raise ValueError(f"unknown chaos point(s): {sorted(unknown)}")
        self.seed = seed
        self.rates = dict(rates)
        self.max_faults = max_faults
        self.schedule = schedule
        self._factories = _default_fault_factories()
        if fault_factories:
            self._factories.update(fault_factories)
        self._mu = threading.Lock()
        points = set(rates) | (schedule.points() if schedule else set())
        self._rngs = {p: random.Random(f"{seed}:{p}") for p in points}
        self._calls = {p: 0 for p in points}
        self._faults = {p: 0 for p in points}
        self._scheduled = {p: 0 for p in points}

    def fire(self, point: str) -> None:
        """Raise this point's fault if the schedule says this call fails."""
        rate = self.rates.get(point)
        if rate is None and point not in self._calls:
            return
        sched = self.schedule
        claimed = sched.claim(point) if sched is not None else None
        with self._mu:
            self._calls[point] += 1
            nth = self._calls[point]
            if claimed is not None:
                self._scheduled[point] += 1
            else:
                if not rate:
                    return
                if (self.max_faults is not None
                        and self._faults[point] >= self.max_faults):
                    return
                if self._rngs[point].random() >= rate:
                    return
                self._faults[point] += 1
        factory = (claimed.factory if claimed is not None
                   and claimed.factory is not None
                   else self._factories.get(point))
        if factory is not None:
            fault = factory(point, nth)
            if fault is None:
                return  # hang-style factory: the stall already happened
            raise fault
        raise ChaosFault(point, nth)

    def stats(self) -> dict[str, dict[str, int]]:
        # the "scheduled" split only appears when a FaultSchedule is
        # attached — purely probabilistic injectors keep the legacy
        # {calls, faults} shape
        with self._mu:
            return {
                p: (
                    {
                        "calls": self._calls[p],
                        "faults": self._faults[p] + self._scheduled[p],
                        "scheduled": self._scheduled[p],
                    }
                    if self.schedule is not None
                    else {
                        "calls": self._calls[p],
                        "faults": self._faults[p],
                    }
                )
                for p in self._calls
            }


# -- global installation ------------------------------------------------------
# A module global read without a lock: installation happens only in tests
# (and only between workloads); the hot-path contract is a single attribute
# load + None check.
_active: ChaosInjector | None = None
_install_mu = threading.Lock()


def maybe_fail(point: str) -> None:
    """The hook every injection point calls. No-op unless an injector is
    installed."""
    inj = _active
    if inj is not None:
        inj.fire(point)


def install(injector: ChaosInjector) -> None:
    global _active
    with _install_mu:
        if _active is not None:
            raise RuntimeError("a chaos injector is already installed")
        if injector.schedule is not None:
            # t=0 for wall-clock offsets is the moment chaos goes live —
            # unless the caller already armed the schedule against its own
            # run clock (arm() keeps the first epoch)
            injector.schedule.arm()
        _active = injector


def uninstall() -> None:
    global _active
    with _install_mu:
        _active = None


@contextlib.contextmanager
def active(injector: ChaosInjector) -> Any:
    """``with chaos.active(ChaosInjector(seed, rates)): ...`` — install for
    the block, always uninstall, even when the workload raises."""
    install(injector)
    try:
        yield injector
    finally:
        uninstall()
