"""Replica membership & failure detection for the router tier (a copy of
``gofr_tpu/serving/membership.py``, stdlib plus the port's chaos tier;
the port imports nothing of the JAX package). A ``ReplicaAnnouncer``
composes its beat from a port engine's ``health_check``,
``prefix_advertisement``, ``preemptible``, ``reclaim_remaining_s`` and
``epoch``; ``hbm_free_frac`` comes from the engine's ``DeviceTelemetry``
sample (``torch.cuda`` memory on the card, None on the CPU).

The scale-out era's first invariant (ROADMAP item 3, AIBrix
arXiv:2504.03648): a router that fronts N engine replicas must know, at
every moment, which replicas may receive new work — without a central
coordinator and without trusting any single signal. Three signals feed
the table:

- **heartbeats**: every replica runs a :class:`ReplicaAnnouncer` that
  publishes its supervisor state (UP/SUSPECT/DRAINING/WEDGED),
  shed queue-wait EWMA and KV/HBM headroom over the existing pubsub
  layer (at-least-once delivery; heartbeats are idempotent by
  ``seq``, so redelivery is harmless);
- **silence**: a replica that misses heartbeats goes SUSPECT after
  ``suspect_after_s`` and DOWN after ``down_after_s`` — the router never
  waits for a failed replica to say it failed;
- **the breaker**: an inter-replica circuit breaker opening
  (service/options.py) forces the replica DOWN immediately, ahead of the
  heartbeat timers — the data path learned faster than the control path.

Routability: UP replicas route; SUSPECT replicas route only when no UP
replica exists (a heartbeat blip must not take the whole tier down);
DRAINING / WEDGED / RESTARTING / DOWN replicas receive **zero** new
routes, ever — DRAINING finishes its in-flight streams, WEDGED needs
replacing (docs/robustness.md "The router plane").
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable

from gofr_tpu_torch import chaos

HEARTBEAT_TOPIC = "replica.heartbeat"

# replica states as seen by the router (superset of the supervisor's:
# DOWN covers both "announced down" and "went silent")
UP = "UP"
SUSPECT = "SUSPECT"
RESTARTING = "RESTARTING"
DRAINING = "DRAINING"
WEDGED = "WEDGED"
DOWN = "DOWN"
# RECLAIMING: a preemptible replica under a reclamation notice — it is
# DRAINING with a hard external deadline (the provider takes the machine
# back whether or not we finish), so it additionally evacuates committed
# KV to survivors. Like DRAINING it receives zero new routes, ever.
RECLAIMING = "RECLAIMING"

# gauge encoding for app_router_replica_state
STATE_VALUES = {
    UP: 0, SUSPECT: 1, RESTARTING: 2, DRAINING: 3, WEDGED: 4, DOWN: 5,
    RECLAIMING: 6,
}

# states that may receive new routes (SUSPECT only as a last resort)
_NEVER_ROUTE = (DRAINING, WEDGED, RESTARTING, DOWN, RECLAIMING)

# replica roles (disaggregated prefill/decode serving, ROADMAP item 2,
# AIBrix arXiv:2504.03648): a UNIFIED replica serves whole generations;
# a PREFILL replica only computes prompt KV (handed off to a decode
# replica over the KV-migration transfer machinery); a DECODE replica admits
# handed-off KV chains and streams tokens. Roles ride the heartbeat so
# the router's policy follows the pool's actual shape, live.
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED)


@dataclasses.dataclass
class Heartbeat:
    """One replica's announcement: identity, supervisor state, and the
    load/headroom signals the router's spill + autoscaling decisions key
    on. ``seq`` is a per-replica monotonic counter — at-least-once pubsub
    may redeliver or reorder beats, and a stale beat must never overwrite
    a newer observation."""

    replica_id: str
    seq: int
    state: str = UP
    # disaggregation role (prefill/decode/unified). Part of the beat, not
    # static registration: a pool driver can repurpose a replica between
    # roles and the router's policy follows within one heartbeat.
    role: str = ROLE_UNIFIED
    queue_wait_s: float = 0.0   # shed EWMA estimate (serving/shed.py)
    queue_depth: int = 0
    slots_free: int = 0
    kv_free_frac: float = 1.0   # paged-KV pool headroom (0..1)
    hbm_free_frac: float | None = None  # device HBM headroom, if known
    ts: float = 0.0             # publisher wall clock, informational only
    # preemptible capacity class (ROADMAP item 5, AIBrix
    # arXiv:2504.03648): True marks a replica the provider may reclaim on
    # short notice. Rides the beat so router steering and the capacity
    # planner see the fleet's actual cost mix, live.
    preemptible: bool = False
    # remaining seconds of an in-progress reclamation notice (None when
    # not reclaiming) — the router/autoscaler read the budget off the
    # beat instead of asking the doomed replica.
    reclaim_deadline_s: float | None = None
    # distributed prefix index (serving/prefix_index.py): a BOUNDED
    # [key, tier] advertisement of this replica's cached prefixes —
    # piggybacked here so the index rides the same idempotent per-replica
    # seq discipline the membership table already enforces. None when
    # the replica advertises nothing (no prefix cache wired).
    prefix_keys: list | None = None
    # HA plane (docs/robustness.md "The HA plane"): the replica's fence
    # epoch — monotonic, bumped on warm_restart / begin_reclaim /
    # announcer re-register. Routers stamp it on every per-attempt call;
    # the engine rejects a stale epoch at the wire (ErrorStaleEpoch),
    # which fences a zombie router acting on a pre-restart view. 0 =
    # unfenced (an engine predating the epoch, or a stub).
    epoch: int = 0

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Heartbeat":
        data = json.loads(raw.decode("utf-8"))
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


class _ReplicaView:
    """The membership table's record of one replica."""

    def __init__(self, replica_id: str, role: str = ROLE_UNIFIED) -> None:
        self.replica_id = replica_id
        self.seq = -1
        self.reported_state = UP
        self.role = role
        self.last_seen: float | None = None  # monotonic arrival time
        self.queue_wait_s = 0.0
        self.queue_depth = 0
        self.slots_free = 0
        self.kv_free_frac = 1.0
        self.hbm_free_frac: float | None = None
        self.forced_down_reason: str | None = None  # breaker-open etc.
        self.preemptible = False
        self.reclaim_deadline_s: float | None = None
        self.epoch = 0  # fence epoch as last gossiped (0 = unfenced)

    def effective_state(self, now: float, suspect_after: float,
                        down_after: float) -> str:
        if self.forced_down_reason is not None:
            return DOWN
        if self.reported_state in _NEVER_ROUTE:
            return self.reported_state
        if self.last_seen is None:
            return SUSPECT  # registered but never heard from
        age = now - self.last_seen
        if age > down_after:
            return DOWN
        if age > suspect_after:
            return SUSPECT
        return self.reported_state

    def snapshot(self, now: float, suspect_after: float,
                 down_after: float) -> dict[str, Any]:
        out: dict[str, Any] = {
            "state": self.effective_state(now, suspect_after, down_after),
            "reported_state": self.reported_state,
            "role": self.role,
            "seq": self.seq,
            "queue_wait_s": round(self.queue_wait_s, 4),
            "queue_depth": self.queue_depth,
            "slots_free": self.slots_free,
            "kv_free_frac": round(self.kv_free_frac, 4),
        }
        if self.epoch:
            out["epoch"] = self.epoch
        if self.preemptible:
            out["preemptible"] = True
        if self.reclaim_deadline_s is not None:
            out["reclaim_deadline_s"] = round(self.reclaim_deadline_s, 3)
        if self.hbm_free_frac is not None:
            out["hbm_free_frac"] = round(self.hbm_free_frac, 4)
        if self.last_seen is not None:
            out["heartbeat_age_s"] = round(now - self.last_seen, 3)
        if self.forced_down_reason is not None:
            out["forced_down"] = self.forced_down_reason
        return out


class MembershipTable:
    """Thread-safe replica table: heartbeats in, routability out.

    ``observe`` ingests a heartbeat (stale ``seq`` dropped — the pubsub
    layer is at-least-once, not ordered), ``mark_down`` is the breaker's
    fast path, ``candidates`` answers the router's question: which
    replicas may receive this request, best first."""

    def __init__(self, suspect_after_s: float = 3.0,
                 down_after_s: float = 10.0) -> None:
        self.suspect_after_s = suspect_after_s
        self.down_after_s = down_after_s
        self._mu = threading.Lock()
        self._replicas: dict[str, _ReplicaView] = {}

    def register(self, replica_id: str, role: str = ROLE_UNIFIED, *,
                 preemptible: bool = False) -> None:
        """Pre-register a replica (the router knows its handles up front);
        it stays SUSPECT until its first heartbeat arrives. ``role`` and
        ``preemptible`` are the registration-time defaults — the
        replica's own heartbeats are authoritative and overwrite them."""
        with self._mu:
            view = self._replicas.setdefault(
                replica_id, _ReplicaView(replica_id, role)
            )
            if view.last_seen is None:
                view.role = role  # never heard from: registration decides
                view.preemptible = preemptible

    def forget(self, replica_id: str) -> None:
        with self._mu:
            self._replicas.pop(replica_id, None)

    def observe(self, hb: Heartbeat, now: float | None = None) -> bool:
        """Ingest one heartbeat; returns False for stale/duplicate beats
        (redelivered or reordered by the at-least-once pubsub layer)."""
        now = time.monotonic() if now is None else now
        with self._mu:
            view = self._replicas.setdefault(
                hb.replica_id, _ReplicaView(hb.replica_id)
            )
            if hb.seq <= view.seq:
                return False
            view.seq = hb.seq
            view.reported_state = hb.state
            if hb.role in ROLES:
                view.role = hb.role  # the beat is authoritative; an
                # unknown role string keeps the last known one (a newer
                # announcer gossiping a role this router predates must
                # not un-route the replica)
            view.last_seen = now
            view.queue_wait_s = float(hb.queue_wait_s)
            view.queue_depth = int(hb.queue_depth)
            view.slots_free = int(hb.slots_free)
            view.kv_free_frac = float(hb.kv_free_frac)
            view.hbm_free_frac = hb.hbm_free_frac
            view.preemptible = bool(hb.preemptible)
            view.reclaim_deadline_s = (
                float(hb.reclaim_deadline_s)
                if hb.reclaim_deadline_s is not None else None
            )
            if hb.epoch > view.epoch:
                # monotonic like seq: a redelivered pre-restart beat must
                # never roll the fence back to an epoch the engine rejects
                view.epoch = int(hb.epoch)
            if hb.state == UP and view.forced_down_reason is not None:
                # a FRESH healthy announcement outranks a stale breaker
                # verdict: the replica proved liveness after the breaker
                # opened (the breaker's own probe will re-close it too)
                view.forced_down_reason = None
            return True

    def mark_down(self, replica_id: str, reason: str = "breaker-open") -> None:
        """The breaker's fast path: the data plane saw the replica fail
        before the heartbeat timers did. Cleared by the next fresh UP
        heartbeat."""
        with self._mu:
            view = self._replicas.setdefault(
                replica_id, _ReplicaView(replica_id)
            )
            view.forced_down_reason = reason

    def state_of(self, replica_id: str, now: float | None = None) -> str:
        now = time.monotonic() if now is None else now
        with self._mu:
            view = self._replicas.get(replica_id)
            if view is None:
                return DOWN
            return view.effective_state(
                now, self.suspect_after_s, self.down_after_s
            )

    def load_of(self, replica_id: str) -> tuple[float, int]:
        """(queue_wait_s EWMA, queue_depth) as last reported."""
        with self._mu:
            view = self._replicas.get(replica_id)
            if view is None:
                return (float("inf"), 0)
            return (view.queue_wait_s, view.queue_depth)

    def headroom_of(self, replica_id: str) -> tuple[float, float | None]:
        """(kv_free_frac, hbm_free_frac) as last reported — the router's
        HBM-pressure spill reads these; hbm is None when the replica
        publishes no device-telemetry signal."""
        with self._mu:
            view = self._replicas.get(replica_id)
            if view is None:
                return (1.0, None)
            return (view.kv_free_frac, view.hbm_free_frac)

    def candidates(self, now: float | None = None, *,
                   role: str | None = None) -> list[str]:
        """Replica ids eligible for NEW work: every UP replica (least
        estimated wait first); when no UP replica exists, SUSPECT
        replicas (same order) — a tier-wide heartbeat blip must degrade
        to best-effort routing, not a total outage. DRAINING / WEDGED /
        RESTARTING / DOWN are never returned.

        ``role`` filters by disaggregation phase: ``role="decode"``
        returns decode + unified replicas, ``role="prefill"`` returns
        prefill + unified — a role-split replica is NEVER handed the
        other phase's work (role-mismatch rejection happens here, at
        candidate assembly, so no later path can route around it).
        ``None`` asks for whole-generation routing: prefill specialists
        are excluded (they must never stream tokens), while decode and
        unified replicas both qualify — a decode replica CAN compute its
        own prefill (role is policy, not capability), which is exactly
        the degrade path a dead handoff source falls back on."""
        now = time.monotonic() if now is None else now
        up: list[_ReplicaView] = []
        suspect: list[_ReplicaView] = []
        with self._mu:
            for view in self._replicas.values():
                if role is None:
                    if view.role == ROLE_PREFILL:
                        continue  # a prefill specialist never streams
                elif view.role not in (role, ROLE_UNIFIED):
                    continue
                state = view.effective_state(
                    now, self.suspect_after_s, self.down_after_s
                )
                if state == UP:
                    up.append(view)
                elif state == SUSPECT:
                    suspect.append(view)
        pool = up if up else suspect
        pool.sort(key=lambda v: (v.queue_wait_s, -v.slots_free, v.replica_id))
        return [v.replica_id for v in pool]

    def epoch_of(self, replica_id: str) -> int:
        """The replica's fence epoch as last gossiped (0 = unknown or
        unfenced). Routers stamp this on every per-attempt engine call;
        an engine that restarted since returns ErrorStaleEpoch and the
        router refreshes from the next beat."""
        with self._mu:
            view = self._replicas.get(replica_id)
            return view.epoch if view is not None else 0

    def is_preemptible(self, replica_id: str) -> bool:
        """Whether the replica runs on reclaimable capacity (as last
        registered or reported) — the router's interactive-class
        steering keys on this."""
        with self._mu:
            view = self._replicas.get(replica_id)
            return view.preemptible if view is not None else False

    def role_of(self, replica_id: str) -> str:
        with self._mu:
            view = self._replicas.get(replica_id)
            return view.role if view is not None else ROLE_UNIFIED

    def roles_present(self, now: float | None = None) -> set[str]:
        """Roles with at least one routable (UP/SUSPECT) replica — the
        router's disaggregation switch: a prefill AND a decode pool both
        present means requests split into a prefill phase + a KV handoff
        + a decode phase."""
        now = time.monotonic() if now is None else now
        out: set[str] = set()
        with self._mu:
            for view in self._replicas.values():
                state = view.effective_state(
                    now, self.suspect_after_s, self.down_after_s
                )
                if state in (UP, SUSPECT):
                    out.add(view.role)
        return out

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        now = time.monotonic() if now is None else now
        with self._mu:
            views = list(self._replicas.values())
        return {
            v.replica_id: v.snapshot(
                now, self.suspect_after_s, self.down_after_s
            )
            for v in views
        }

    def aggregate_queue_wait(self, role: str | None = None) -> float:
        """Mean reported queue-wait across live (UP/SUSPECT) replicas —
        the tier-level autoscaling signal (scale up when the whole tier
        is waiting, not when one replica hiccups). ``role`` narrows the
        mean to one pool — the SAME pool ``candidates(role=)`` routes
        to, unified replicas included: they absorb that role's traffic,
        and a signal blind to them would read a saturated mixed pool as
        idle and scale it down. The autoscaler sizes prefill and decode
        pools independently (a prefill backlog must grow the prefill
        pool, not add decode replicas that would sit idle)."""
        now = time.monotonic()
        with self._mu:
            waits = [
                v.queue_wait_s for v in self._replicas.values()
                if (role is None or v.role in (role, ROLE_UNIFIED))
                and v.effective_state(
                    now, self.suspect_after_s, self.down_after_s
                ) in (UP, SUSPECT)
            ]
        return sum(waits) / len(waits) if waits else 0.0

    def min_hbm_headroom(self, role: str | None = None) -> float | None:
        """The tightest reported HBM headroom across live replicas (of
        ``role``'s pool — unified replicas included, matching
        ``candidates(role=)`` — or all) — the autoscaler's
        memory-pressure signal. None when no live replica publishes a
        device-telemetry sample."""
        now = time.monotonic()
        best: float | None = None
        with self._mu:
            for v in self._replicas.values():
                if role is not None and v.role not in (role, ROLE_UNIFIED):
                    continue
                if v.effective_state(
                    now, self.suspect_after_s, self.down_after_s
                ) not in (UP, SUSPECT):
                    continue
                if v.hbm_free_frac is None:
                    continue
                if best is None or v.hbm_free_frac < best:
                    best = v.hbm_free_frac
        return best


class ReplicaAnnouncer:
    """The replica-side half of membership: a daemon thread that
    publishes this engine's heartbeat every ``interval_s`` over the
    pubsub layer, carrying supervisor state, shed EWMA queue-wait and
    KV headroom straight out of ``engine.health_check()``.

    The ``router.heartbeat`` chaos point sits on the publish path: a
    fault there IS a network partition — the beat is dropped (counted,
    never raised into the engine) and the router's timers must do the
    rest. Stop publishes one final beat so a deliberate drain/stop
    reaches the router ahead of the suspect timer."""

    def __init__(
        self,
        replica_id: str,
        engine: Any,
        publisher: Any,
        *,
        topic: str = HEARTBEAT_TOPIC,
        interval_s: float = 1.0,
        logger: Any = None,
        hbm_headroom: Callable[[], float | None] | None = None,
        advert_limit: int = 128,
        role: str | None = None,
    ) -> None:
        self.replica_id = replica_id
        self.engine = engine
        self.publisher = publisher
        self.topic = topic
        self.interval_s = interval_s
        self._logger = logger
        self._hbm_headroom = hbm_headroom
        # disaggregation role carried on every beat: explicit param wins,
        # else the engine's own declared role, else unified. A plain
        # string attribute — a pool driver repurposing the replica flips
        # it and the next beat reroutes the tier.
        self.role = role or getattr(engine, "role", None) or ROLE_UNIFIED
        # prefix-index advertisement bound: a heartbeat must stay a
        # heartbeat (0 disables advertising entirely)
        self.advert_limit = advert_limit
        self._seq = 0
        self._seq_mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.dropped_beats = 0  # partitioned (chaos) or failed publishes
        # terminal beats (stop's final announcement) lost even after the
        # bounded retry: the router waits out the SUSPECT timer instead
        self.dropped_final_beats = 0
        self._started_once = False  # a second start() is a re-register

    # -- heartbeat composition -------------------------------------------------
    def compose(self) -> Heartbeat:
        health: dict[str, Any] = {}
        try:
            health = self.engine.health_check() or {}
        except Exception:
            health = {"status": WEDGED, "details": {}}
        details = health.get("details") or {}
        shed = details.get("shed") or {}
        slots_total = details.get("slots_total", 0)
        slots_active = details.get("slots_active", 0)
        kv = details.get("kv_pages") or {}
        total_blocks = kv.get("total_blocks") or 0
        free_blocks = kv.get("free_blocks") or 0
        kv_free = (free_blocks / total_blocks) if total_blocks else 1.0
        depth = int(details.get("queue_depth", 0))
        ewma = float(shed.get("ewma_request_s", 0.0))
        waves = depth / max(int(slots_total) or 1, 1)
        if self._hbm_headroom is not None:
            hbm = self._hbm_headroom()
        else:
            # default wiring: the engine's device-telemetry poller
            # (serving/device_telemetry.py) publishes real HBM headroom —
            # the router's spill decisions act on actual device pressure,
            # not a permanently-stubbed None
            poller = getattr(self.engine, "device_telemetry", None)
            hbm = poller.hbm_headroom() if poller is not None else None
        prefix_keys = None
        if self.advert_limit > 0:
            advertise = getattr(self.engine, "prefix_advertisement", None)
            if advertise is not None:
                try:
                    prefix_keys = advertise(self.advert_limit)
                except Exception:
                    prefix_keys = None  # the index is advisory: never
                    # let it break the heartbeat the router's failure
                    # detection depends on
        # reclamation plane: the capacity class and, mid-notice, the
        # remaining evacuation budget ride the same beat the router's
        # failure detection already trusts
        preemptible = bool(getattr(self.engine, "preemptible", False))
        reclaim_deadline = None
        remaining = getattr(self.engine, "reclaim_remaining_s", None)
        if remaining is not None:
            try:
                reclaim_deadline = remaining()
            except Exception:
                reclaim_deadline = None
        with self._seq_mu:
            self._seq += 1
            seq = self._seq
        return Heartbeat(
            replica_id=self.replica_id,
            seq=seq,
            state=str(health.get("status", UP)),
            role=self.role,
            queue_wait_s=waves * ewma,
            queue_depth=depth,
            slots_free=max(int(slots_total) - int(slots_active), 0),
            kv_free_frac=kv_free,
            hbm_free_frac=hbm,
            ts=time.time(),
            prefix_keys=prefix_keys,
            preemptible=preemptible,
            reclaim_deadline_s=reclaim_deadline,
            # fence epoch gossips on every beat (0 for engines/stubs
            # that predate the HA plane — unfenced)
            epoch=int(getattr(self.engine, "epoch", 0) or 0),
        )

    def beat(self) -> bool:
        """Compose and publish one heartbeat. Returns False when the beat
        was dropped — an injected partition (``router.heartbeat``) or a
        broker failure; the announcer never lets either escape into the
        engine, because losing the control path must not hurt the data
        path."""
        hb = self.compose()
        try:
            chaos.maybe_fail("router.heartbeat")
            self.publisher.publish(self.topic, hb.to_json())
            return True
        except Exception as exc:
            self.dropped_beats += 1
            if self._logger is not None:
                self._logger.debug(
                    f"replica {self.replica_id}: heartbeat dropped: {exc}"
                )
            return False

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        if self._started_once:
            # re-register: this announcer is re-joining the tier (a
            # stop/start cycle a router may have observed as DOWN). Bump
            # the engine's fence epoch so any caller still holding the
            # pre-departure view is fenced — same rule as warm_restart.
            epoch = getattr(self.engine, "epoch", None)
            if isinstance(epoch, int):
                self.engine.epoch = epoch + 1
        self._started_once = True
        self.beat()  # announce immediately: the router learns of this
        # replica one beat sooner than the interval
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"replica-announcer-{self.replica_id}",
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self, final_beat: bool = True) -> None:
        """Stop announcing. ``final_beat`` publishes the engine's current
        state one last time (DRAINING on a graceful drain, DOWN after a
        stop) so the router reacts immediately instead of waiting out the
        suspect timer.

        The terminal beat is the one beat with no successor to paper over
        a dropped publish, so it gets ONE bounded, jittered retry (the
        jitter is deterministic per replica — a fleet-wide drain must not
        retry in lockstep against the broker that just dropped it). A
        beat lost twice is counted in ``dropped_final_beats``: the router
        falls back to its SUSPECT timer, which is the pre-existing
        behavior — the retry only narrows the window, never blocks stop
        beyond one interval."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        self._thread = None
        if final_beat and not self.beat():
            import zlib

            jitter = (zlib.crc32(self.replica_id.encode()) % 50) / 1000.0
            time.sleep(min(self.interval_s * 0.5, 0.1) + jitter)
            if not self.beat():
                self.dropped_final_beats += 1
                if self._logger is not None:
                    self._logger.warn(
                        f"replica {self.replica_id}: terminal heartbeat "
                        "lost twice; router will rely on its suspect timer"
                    )
