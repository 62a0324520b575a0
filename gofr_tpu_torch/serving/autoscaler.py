"""The headroom-driven replica autoscaler (ROADMAP item 2, AIBrix
arXiv:2504.03648), a copy of ``gofr_tpu/serving/autoscaler.py`` over the
port's chaos tier and membership (the port imports nothing of the JAX
package). :func:`engine_factory` is the port's own: a
``SimulatedPoolDriver`` factory that builds port engines (on the card
unless given ``device="cpu"``), each behind a ``LocalReplica`` with its
heartbeat announcer; :func:`release_replica` is its ``on_reap`` hook.

The router tier watches every replica's queue-wait EWMA and HBM
headroom ride the membership heartbeats — but until this module nothing
ACTED on the signal: an operator read ``/routerz`` and resized the pool
by hand. The :class:`Autoscaler` closes the loop, per role (a role-split
tier sizes its prefill and decode pools independently — a prefill
backlog must grow the prefill pool, not add decode replicas that would
sit idle):

- **signal**: the role pool's mean queue-wait EWMA
  (``MembershipTable.aggregate_queue_wait`` — the same series
  ``app_router_queue_wait_seconds`` exports) and its tightest reported
  HBM headroom (``min_hbm_headroom``, fed by the device-telemetry
  poller);
- **hysteresis**: pressure must PERSIST for ``up_stable_s`` before a
  scale-up, idleness for ``down_stable_s`` before a scale-down, and
  every action starts a per-role ``cooldown_s`` — a bursty signal must
  not flap the pool (adding a replica costs a cold jit cache; removing
  one costs its warm KV);
- **the scale-down invariant** (chaos-tested,
  tests/test_router_chaos.py): a victim is DRAINED, never killed — the
  driver's ``begin_drain`` runs the replica's graceful-drain contract
  (in-flight streams and handoffs finish, the DRAINING heartbeat stops
  new routes) and the replica is reaped only once it reports idle.
  Zero lost requests, whatever the scaler does.

The **driver** is the deployment-shaped seam: :class:`ReplicaPoolDriver`
is the k8s-shaped interface (scale a Deployment per role, cordon+drain a
pod, reap it when idle); :class:`SimulatedPoolDriver` implements it over
an in-process replica factory so the control loop's behavior is testable
— and chaos-testable — without a cluster.

The ``scale.decision`` chaos point sits on each per-role decision: a
fault there skips the round's action (counted, never raised into the
loop) — the control plane misfiring must degrade to "pool stays its
current size", never to a kill.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

from gofr_tpu_torch import chaos
from gofr_tpu_torch.serving import membership as ms
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
from gofr_tpu_torch.serving.router import LocalReplica

__all__ = ["AutoscalerConfig", "Autoscaler", "SimulatedPoolDriver", "engine_factory",
           "release_replica"]


@dataclasses.dataclass
class AutoscalerConfig:
    """Every knob env-tunable, like RouterConfig (docs/robustness.md has
    the table)."""

    interval_s: float = 1.0
    min_replicas: int = 1
    max_replicas: int = 8
    # queue-wait EWMA above this → the pool is under pressure
    scale_up_wait_s: float = 1.0
    # queue-wait EWMA below this (with no HBM pressure) → the pool idles
    scale_down_wait_s: float = 0.1
    # tightest reported HBM headroom below this fraction → pressure
    # (replicas that publish no device sample never trigger it)
    hbm_floor_frac: float = 0.05
    # hysteresis: how long the signal must persist before acting, and
    # the per-role quiet period after every action
    up_stable_s: float = 2.0
    down_stable_s: float = 10.0
    cooldown_s: float = 5.0

    @classmethod
    def from_config(cls, config: Any) -> "AutoscalerConfig":
        return cls(
            interval_s=float(
                config.get_or_default("TPU_AUTOSCALE_INTERVAL_S", "1.0")
            ),
            min_replicas=int(
                config.get_or_default("TPU_AUTOSCALE_MIN_REPLICAS", "1")
            ),
            max_replicas=int(
                config.get_or_default("TPU_AUTOSCALE_MAX_REPLICAS", "8")
            ),
            scale_up_wait_s=float(
                config.get_or_default("TPU_AUTOSCALE_UP_WAIT_S", "1.0")
            ),
            scale_down_wait_s=float(
                config.get_or_default("TPU_AUTOSCALE_DOWN_WAIT_S", "0.1")
            ),
            hbm_floor_frac=float(
                config.get_or_default("TPU_AUTOSCALE_HBM_FLOOR", "0.05")
            ),
            up_stable_s=float(
                config.get_or_default("TPU_AUTOSCALE_UP_STABLE_S", "2.0")
            ),
            down_stable_s=float(
                config.get_or_default("TPU_AUTOSCALE_DOWN_STABLE_S", "10.0")
            ),
            cooldown_s=float(
                config.get_or_default("TPU_AUTOSCALE_COOLDOWN_S", "5.0")
            ),
        )


class ReplicaPoolDriver:
    """The deployment seam the autoscaler drives — k8s-shaped on
    purpose: ``scale_up`` maps to growing a per-role Deployment,
    ``begin_drain`` to cordoning a pod and invoking its graceful-drain
    hook, ``reap`` to deleting it once idle. Implementations must make
    ``begin_drain`` NON-DESTRUCTIVE: in-flight streams and handoffs on
    the victim run to completion (the scale-down invariant)."""

    def replica_ids(self, role: str) -> list[str]:
        """Live (non-draining) replica ids of this role."""
        raise NotImplementedError

    def scale_up(self, role: str, n: int, *,
                 preemptible: bool = False) -> list[str]:
        """Add ``n`` replicas to the role's pool; returns their ids.
        ``preemptible`` requests reclaimable (spot) capacity — cheaper,
        but the provider may :meth:`notice` it back at any time."""
        raise NotImplementedError

    def begin_drain(self, replica_id: str) -> None:
        """Start the victim's graceful drain (never blocks the caller,
        never kills in-flight work)."""
        raise NotImplementedError

    def notice(self, replica_id: str, deadline_s: float = 5.0) -> bool:
        """Deliver a reclamation notice (docs/robustness.md "The
        reclamation plane"): the provider takes ``replica_id``'s machine
        back in ``deadline_s`` seconds. Implementations run the
        replica's ``begin_reclaim`` ladder (deadline-bounded drain +
        bulk KV evacuation) without blocking the caller, and report the
        event to a wired ``on_notice`` observer. Returns False when the
        notice was lost in delivery."""
        raise NotImplementedError

    def reap(self, replica_id: str) -> bool:
        """Remove a draining replica IF it is idle; False = still busy,
        try again next tick."""
        raise NotImplementedError


class SimulatedPoolDriver(ReplicaPoolDriver):
    """An in-process pool: ``factory(role, replica_id) -> handle`` builds
    a replica (a LocalReplica-compatible handle over a real engine or a
    stub), the driver registers it with the router and tracks its
    lifecycle. Drains run the handle's (or its engine's) ``drain`` on a
    daemon thread — an engine's drain blocks until its streams finish,
    which is exactly the semantics the invariant wants — and ``reap``
    removes the replica only once its health reports nothing in flight.
    """

    def __init__(self, router: Any,
                 factory: Callable[[str, str], Any],
                 *, on_reap: Callable[[Any], None] | None = None,
                 on_notice: Callable[..., None] | None = None) -> None:
        self.router = router
        self.factory = factory
        self._on_reap = on_reap
        # reclamation observer: called (replica_id, role=, deadline_s=)
        # after a notice is DELIVERED — the autoscaler self-wires here
        # (Autoscaler.observe_notice) to backfill outside its hysteresis
        self.on_notice = on_notice
        self._mu = threading.Lock()
        self._handles: dict[str, Any] = {}
        self._roles: dict[str, str] = {}
        self._preemptible: set[str] = set()
        self._draining: set[str] = set()
        self._drained: set[str] = set()  # drain call returned
        self._next = 0
        self.notices_total = 0
        self.notices_dropped_total = 0  # replica.reclaim chaos faults

    # -- driver surface --------------------------------------------------------
    def replica_ids(self, role: str) -> list[str]:
        with self._mu:
            return [
                rid for rid, r in self._roles.items()
                if r == role and rid not in self._draining
            ]

    def preemptible_ids(self, role: str | None = None) -> list[str]:
        """Live (non-draining) preemptible replica ids — the notice-storm
        injectors and the capacity planner enumerate the reclaimable
        share of the fleet through this."""
        with self._mu:
            return [
                rid for rid, r in self._roles.items()
                if (role is None or r == role)
                and rid in self._preemptible
                and rid not in self._draining
            ]

    def role_of(self, replica_id: str) -> str | None:
        with self._mu:
            return self._roles.get(replica_id)

    def scale_up(self, role: str, n: int, *,
                 preemptible: bool = False) -> list[str]:
        out = []
        for _ in range(n):
            with self._mu:
                self._next += 1
                rid = f"{role}-{self._next}"
            handle = self._make(role, rid, preemptible)
            with self._mu:
                self._handles[rid] = handle
                self._roles[rid] = role
                if preemptible:
                    self._preemptible.add(rid)
            self.router.add_replica(handle, role=role)
            out.append(rid)
        return out

    def _make(self, role: str, rid: str, preemptible: bool) -> Any:
        """Build one replica. Existing 2-arg factories keep working; a
        factory declaring ``preemptible`` (or **kwargs) receives the
        capacity class so it can set ``EngineConfig.preemptible`` and
        the handle attribute the router's steering reads."""
        if preemptible:
            try:
                import inspect

                params = inspect.signature(self.factory).parameters
                accepts = "preemptible" in params or any(
                    p.kind == p.VAR_KEYWORD for p in params.values()
                )
            except (TypeError, ValueError):
                accepts = False
            if accepts:
                return self.factory(role, rid, preemptible=True)
            handle = self.factory(role, rid)
            # best-effort: mark the handle (and its engine) so the
            # heartbeat + router steering still see the capacity class
            try:
                handle.preemptible = True
                engine = getattr(handle, "engine", None)
                if engine is not None:
                    engine.preemptible = True
            except Exception:
                pass
            return handle
        return self.factory(role, rid)

    def begin_drain(self, replica_id: str) -> None:
        with self._mu:
            if replica_id in self._draining:
                return
            handle = self._handles.get(replica_id)
            if handle is None:
                return
            self._draining.add(replica_id)
        drain = getattr(handle, "drain", None) or getattr(
            getattr(handle, "engine", None), "drain", None
        )

        def run() -> None:
            try:
                if drain is not None:
                    drain()  # blocks until in-flight work finished
            finally:
                with self._mu:
                    self._drained.add(replica_id)

        threading.Thread(
            target=run, daemon=True, name=f"drain-{replica_id}"
        ).start()

    def notice(self, replica_id: str, deadline_s: float = 5.0) -> bool:
        """Reclamation-notice injector: delivers the provider's
        "machine goes away in ``deadline_s`` seconds" webhook to the
        replica. The ``replica.reclaim`` chaos point sits ON delivery —
        a fault there means the notice is LOST (counted; the replica
        keeps serving until the machine actually dies, which the loadlab
        kill path models separately) — never a kill here. A delivered
        notice runs the replica's ``begin_reclaim`` ladder
        (deadline-bounded drain + bulk KV evacuation; plain ``drain``
        when the handle predates the reclamation plane) on a daemon
        thread and reports to ``on_notice`` so the autoscaler can
        backfill immediately."""
        with self._mu:
            handle = self._handles.get(replica_id)
            role = self._roles.get(replica_id)
        if handle is None:
            return False
        try:
            chaos.maybe_fail("replica.reclaim")
        except Exception:
            self.notices_dropped_total += 1
            return False
        self.notices_total += 1
        with self._mu:
            already = replica_id in self._draining
            self._draining.add(replica_id)
        if not already:
            engine = getattr(handle, "engine", None)
            reclaim = getattr(handle, "begin_reclaim", None) or getattr(
                engine, "begin_reclaim", None
            )
            drain = getattr(handle, "drain", None) or getattr(
                engine, "drain", None
            )

            def run() -> None:
                try:
                    if reclaim is not None:
                        reclaim(deadline_s)
                    elif drain is not None:
                        drain(deadline_s)
                finally:
                    with self._mu:
                        self._drained.add(replica_id)

            threading.Thread(
                target=run, daemon=True, name=f"reclaim-{replica_id}"
            ).start()
        if self.on_notice is not None:
            try:
                self.on_notice(
                    replica_id, role=role, deadline_s=deadline_s
                )
            except Exception:
                pass  # the observer must not break notice delivery
        return True

    def _idle(self, handle: Any) -> bool:
        try:
            health = handle.health_check() or {}
        except Exception:
            return True  # a replica too dead to answer holds nothing
        details = health.get("details") or {}
        return (
            int(details.get("slots_active", 0)) == 0
            and int(details.get("queue_depth", 0)) == 0
        )

    def reap(self, replica_id: str) -> bool:
        with self._mu:
            handle = self._handles.get(replica_id)
            drained = replica_id in self._drained
        if handle is None:
            return True
        if not drained and not self._idle(handle):
            return False  # in-flight streams/handoffs still running
        self.router.remove_replica(replica_id)
        with self._mu:
            self._handles.pop(replica_id, None)
            self._roles.pop(replica_id, None)
            self._preemptible.discard(replica_id)
            self._draining.discard(replica_id)
            self._drained.discard(replica_id)
        if self._on_reap is not None:
            try:
                self._on_reap(handle)
            except Exception:
                pass  # teardown hooks must not wedge the scaler
        return True

    def handle(self, replica_id: str) -> Any:
        with self._mu:
            return self._handles.get(replica_id)


def engine_factory(cfg: Any, params: dict, engine_config: EngineConfig | None = None, *,
                   publisher: Any = None, heartbeat_s: float = 1.0,
                   device: Any = None, **engine_kw: Any) -> Callable[..., LocalReplica]:
    """A :class:`SimulatedPoolDriver` factory over port engines:
    ``factory(role, replica_id, preemptible=False)`` builds a
    ``ServingEngine`` over the shared ``params`` with ``engine_config``'s
    knobs, the role and the capacity class filled in, starts it, and
    returns its ``LocalReplica``. With a ``publisher`` (an
    ``InMemoryBroker``) the replica announces itself every
    ``heartbeat_s`` (the handle's ``announcer``). ``device`` is the
    engine's: the card unless ``"cpu"`` is asked for."""
    base = engine_config or EngineConfig()

    def factory(role: str, replica_id: str, preemptible: bool = False) -> LocalReplica:
        conf = dataclasses.replace(base, role=role, preemptible=preemptible)
        engine = ServingEngine(cfg, params, conf, device=device, **engine_kw)
        engine.start()
        handle = LocalReplica(replica_id, engine, role=role)
        handle.announcer = None
        if publisher is not None:
            handle.announcer = ms.ReplicaAnnouncer(replica_id, engine, publisher,
                                                   interval_s=heartbeat_s)
            handle.announcer.start()
        return handle

    return factory


def release_replica(handle: Any) -> None:
    """The ``on_reap`` hook for :func:`engine_factory`'s replicas: the
    announcer's final beat, then the engine's stop, then the handle lets
    go of both, so the reaped engine's KV leaves the card once the caller
    drops the handle too."""
    announcer = getattr(handle, "announcer", None)
    if announcer is not None:
        announcer.stop()
        announcer.engine = None
        handle.announcer = None
    engine = getattr(handle, "engine", None)
    if engine is not None:
        engine.stop()
        handle.engine = None


class _RoleState:
    __slots__ = ("pressure_since", "idle_since", "last_action_at")

    def __init__(self) -> None:
        self.pressure_since: float | None = None
        self.idle_since: float | None = None
        self.last_action_at = 0.0


class Autoscaler:
    """The control loop: one decision per role per tick, hysteresis on
    both edges, drain-then-reap on the way down."""

    def __init__(
        self,
        router: Any,
        driver: ReplicaPoolDriver,
        config: AutoscalerConfig | None = None,
        *,
        roles: tuple[str, ...] = (ms.ROLE_UNIFIED,),
        metrics: Any = None,
        logger: Any = None,
    ) -> None:
        self.router = router
        self.driver = driver
        self.config = config or AutoscalerConfig()
        self.roles = tuple(roles)
        self._metrics = metrics
        self._logger = logger
        self._states: dict[str, _RoleState] = {
            role: _RoleState() for role in self.roles
        }
        self._reaping: set[str] = set()
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.decisions_skipped_total = 0  # scale.decision chaos faults
        self.notices_observed_total = 0  # reclamation forced-drains seen
        self.decisions: list[dict[str, Any]] = []  # bounded action log
        # reclamation wiring: a SimulatedPoolDriver-shaped driver exposes
        # on_notice — self-wire the forced-drain observer unless the
        # caller already installed one
        if getattr(driver, "on_notice", False) is None:
            driver.on_notice = self.observe_notice

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="autoscaler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception as exc:
                # the control plane misfiring must never take the data
                # plane with it: log, keep ticking
                if self._logger is not None:
                    self._logger.error(f"autoscaler tick failed: {exc}")

    # -- the decision ----------------------------------------------------------
    def tick(self, now: float | None = None) -> None:
        """One control round: reap any draining victims, then one
        decision per role. Public for deterministic tests (the loop just
        calls it on the interval)."""
        now = time.monotonic() if now is None else now
        with self._mu:
            reaping = list(self._reaping)
        for rid in reaping:
            if self.driver.reap(rid):
                with self._mu:
                    self._reaping.discard(rid)
        for role in self.roles:
            self._decide(role, now)
        if self._metrics is not None:
            for role in self.roles:
                self._metrics.set_gauge(
                    "app_autoscaler_replicas",
                    float(len(self.driver.replica_ids(role))),
                    role=role,
                )

    def _decide(self, role: str, now: float) -> None:
        cfg = self.config
        state = self._states[role]
        try:
            chaos.maybe_fail("scale.decision")
        except Exception:
            # a faulted decision round: the pool keeps its size — the
            # failure mode is "no action", never a kill
            self.decisions_skipped_total += 1
            return
        wait = self.router.membership.aggregate_queue_wait(role)
        hbm = self.router.membership.min_hbm_headroom(role)
        current = len(self.driver.replica_ids(role))
        pressure = wait > cfg.scale_up_wait_s or (
            hbm is not None and hbm < cfg.hbm_floor_frac
        )
        idle = not pressure and wait < cfg.scale_down_wait_s
        # hysteresis edges: the signal must persist
        if pressure:
            state.idle_since = None
            if state.pressure_since is None:
                state.pressure_since = now
        elif idle:
            state.pressure_since = None
            if state.idle_since is None:
                state.idle_since = now
        else:
            state.pressure_since = None
            state.idle_since = None
        in_cooldown = now - state.last_action_at < cfg.cooldown_s
        if in_cooldown:
            return
        if (
            pressure
            and state.pressure_since is not None
            and now - state.pressure_since >= cfg.up_stable_s
            and current < cfg.max_replicas
        ):
            added = self.driver.scale_up(role, 1)
            state.last_action_at = now
            state.pressure_since = None
            self.scale_ups_total += 1
            self._record(role, "up", added, wait, hbm, current + 1)
            return
        if (
            idle
            and state.idle_since is not None
            and now - state.idle_since >= cfg.down_stable_s
            and current > cfg.min_replicas
        ):
            victim = self._pick_victim(role)
            if victim is None:
                return
            # DRAIN, never kill: the victim finishes its in-flight
            # streams and handoffs, stops receiving routes via its
            # DRAINING heartbeat, and is reaped only once idle
            self.driver.begin_drain(victim)
            with self._mu:
                self._reaping.add(victim)
            state.last_action_at = now
            state.idle_since = None
            self.scale_downs_total += 1
            self._record(role, "down", [victim], wait, hbm, current - 1)

    def observe_notice(self, replica_id: str, *, role: str | None = None,
                       deadline_s: float | None = None) -> None:
        """A reclamation notice is a FORCED drain from outside the
        control loop: the victim is already reclaiming (the driver ran
        its ladder at delivery), so hysteresis and cooldown do not apply
        — this round's job is (a) adopt the victim into the reap cycle
        (drain-never-kill: reap waits for idle exactly like a scale-down
        victim) and (b) backfill the lost capacity IMMEDIATELY, ahead of
        the queue-wait signal the notice will cause seconds from now.
        The backfill is ON-DEMAND capacity by construction (scale_up's
        default): replacing reclaimed spot with more spot mid-storm
        would just get noticed again."""
        self.notices_observed_total += 1
        with self._mu:
            self._reaping.add(replica_id)
        if role is None:
            role_of = getattr(self.driver, "role_of", None)
            role = role_of(replica_id) if role_of is not None else None
        if role is None or role not in self.roles:
            return  # not a pool this scaler sizes: adopt-for-reap only
        cfg = self.config
        current = len(self.driver.replica_ids(role))
        if current >= cfg.max_replicas:
            return
        added = self.driver.scale_up(role, 1)
        self.scale_ups_total += 1
        self._record(
            role, "backfill", added,
            self.router.membership.aggregate_queue_wait(role),
            None, current + 1,
        )

    def _pick_victim(self, role: str) -> str | None:
        """Least-loaded live replica of the role — draining the emptiest
        pod loses the least warm KV and finishes fastest."""
        ids = self.driver.replica_ids(role)
        if not ids:
            return None
        loads = [
            (self.router.membership.load_of(rid), rid) for rid in ids
        ]
        loads.sort()
        return loads[0][1]

    def _record(self, role: str, direction: str, ids: list[str],
                wait: float, hbm: float | None, target: int) -> None:
        entry = {
            "role": role, "direction": direction, "replicas": ids,
            "queue_wait_s": round(wait, 4),
            "hbm_free_frac": round(hbm, 4) if hbm is not None else None,
            "target": target, "t": time.time(),
        }
        self.decisions.append(entry)
        del self.decisions[:-64]  # bounded
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_autoscaler_scale_events_total", direction=direction,
            )
        if self._logger is not None:
            self._logger.info(
                f"autoscaler: {role} scale-{direction} → {target} "
                f"(queue_wait={wait:.3f}s hbm={hbm})"
            )

    # -- observability ---------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        with self._mu:
            reaping = sorted(self._reaping)
        return {
            "roles": {
                role: {
                    "replicas": self.driver.replica_ids(role),
                    "queue_wait_s": round(
                        self.router.membership.aggregate_queue_wait(role), 4
                    ),
                }
                for role in self.roles
            },
            "draining": reaping,
            "scale_ups_total": self.scale_ups_total,
            "scale_downs_total": self.scale_downs_total,
            "decisions_skipped_total": self.decisions_skipped_total,
            "notices_observed_total": self.notices_observed_total,
            "decisions": list(self.decisions[-16:]),
        }
