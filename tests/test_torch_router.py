"""The port's router tier against the JAX package's, on the CPU, over stub
replicas (the port's ``testutil/replica.py`` on the port side, the
reference's on the other):

- ``prefix_affinity_key`` and ``_HashRing.lookup`` equal the reference's
  for 1000 seeded prompts, strings and token lists;
- ``RouterConfig.from_config`` and ``AutoscalerConfig.from_config`` knob by
  knob;
- a port router over port stubs against a reference router over reference
  stubs on the same scripted scenarios: kill, wedge, drain, revive, a
  heartbeat partition, ``router.route`` faults at the chaos seeds
  101/202/303, a keyed duplicate (``router.claim`` hit and faulted),
  hedging with a fixed delay and a role-split tier. Each request's
  sequence of replicas tried, its terminal outcome (exactly one per
  request) and the router's counters are equal, and ``routerz()`` has the
  same keys;
- each class of the port's ``RETRIABLE_ERRORS`` fails over, and the JAX
  package's ``ErrorServiceUnavailable`` is not one of them.

Scenarios wait on events, never on sleeps that a loaded host could
outrun: a stub's first token waits until the test kills, wedges or cancels
it, and heartbeats are fed to membership directly with explicit ages.
"""

import concurrent.futures
import dataclasses
import time

import numpy as np
import pytest

from gofr_tpu import chaos as jchaos
from gofr_tpu.config import MapConfig
from gofr_tpu.http import errors as jerrors
from gofr_tpu.serving import autoscaler as jauto
from gofr_tpu.serving import membership as jms
from gofr_tpu.serving import router as jrouter
from gofr_tpu.testutil.replica import StubReplicaEngine as JStub

pytest.importorskip("torch")

from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.serving import autoscaler as tauto  # noqa: E402
from gofr_tpu_torch.serving import membership as tms  # noqa: E402
from gofr_tpu_torch.serving import router as trouter  # noqa: E402
from gofr_tpu_torch.testutil.replica import StubReplicaEngine as TStub  # noqa: E402

CHAOS_SEEDS = (101, 202, 303)
LONG = 30.0  # a first-token delay the scenario always interrupts
TIMEOUT = 10.0


# ------------------------------------------------------------ affinity keys


def _prompts(seed: int, n: int = 1000) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2:
            out.append([int(t) for t in rng.integers(0, 128256, int(rng.integers(1, 80)))])
        else:
            n_chars = int(rng.integers(0, 120))
            out.append("".join(chr(int(c)) for c in rng.integers(32, 0x2FF, n_chars)))
    return out


@pytest.mark.parametrize("units", [1, 16, 32, 64])
def test_affinity_keys_and_ring_match_the_reference(units):
    prompts = _prompts(units)
    ids = ["rep-0", "rep-1", "prefill-2", "decode-3", "unified-4"]
    rings = [trouter._HashRing(ids, 64), jrouter._HashRing(ids, 64)]
    assert rings[0]._points == rings[1]._points
    for prompt in prompts:
        key = trouter.prefix_affinity_key(prompt, units)
        assert key == jrouter.prefix_affinity_key(prompt, units)
        assert rings[0].lookup(key) == rings[1].lookup(key)
        adapter_key = key + b"adapter-a"
        assert rings[0].lookup(adapter_key) == rings[1].lookup(adapter_key)
    assert trouter._HashRing([], 64).lookup(b"k") is None


# ------------------------------------------------------------ config knobs


ROUTER_KNOBS = {
    "TPU_ROUTER_HEARTBEAT_S": "0.2", "TPU_ROUTER_SUSPECT_AFTER_S": "1.5",
    "TPU_ROUTER_DOWN_AFTER_S": "4", "TPU_ROUTER_SPILL_WAIT_S": "0.75",
    "TPU_ROUTER_AFFINITY_TOKENS": "48", "TPU_ROUTER_VNODES": "16",
    "TPU_ROUTER_MAX_FAILOVERS": "5", "TPU_ROUTER_HEDGE_DELAY_S": "0.3",
    "TPU_ROUTER_HEDGE_P99": "false", "TPU_ROUTER_SPILL_HBM_FRAC": "0.1",
    "TPU_ROUTER_HEARTBEAT_TOPIC": "beats",
}
AUTOSCALE_KNOBS = {
    "TPU_AUTOSCALE_INTERVAL_S": "0.5", "TPU_AUTOSCALE_MIN_REPLICAS": "2",
    "TPU_AUTOSCALE_MAX_REPLICAS": "6", "TPU_AUTOSCALE_UP_WAIT_S": "2.5",
    "TPU_AUTOSCALE_DOWN_WAIT_S": "0.2", "TPU_AUTOSCALE_HBM_FLOOR": "0.1",
    "TPU_AUTOSCALE_UP_STABLE_S": "0.5", "TPU_AUTOSCALE_DOWN_STABLE_S": "1",
    "TPU_AUTOSCALE_COOLDOWN_S": "1",
}


@pytest.mark.parametrize("knob", sorted(ROUTER_KNOBS) + sorted(AUTOSCALE_KNOBS))
@pytest.mark.parametrize("state", ["set", "unset"])
def test_from_config_matches_the_reference(knob, state):
    """Each knob alone, set and unset, gives the reference's config (the
    port reads any object with ``get`` and ``get_or_default``; the
    reference's ``MapConfig`` is one)."""
    knobs = ROUTER_KNOBS if knob in ROUTER_KNOBS else AUTOSCALE_KNOBS
    pair = ((trouter.RouterConfig, jrouter.RouterConfig) if knob in ROUTER_KNOBS
            else (tauto.AutoscalerConfig, jauto.AutoscalerConfig))
    config = MapConfig({knob: knobs[knob]} if state == "set" else {}, use_env=False)
    mine, ref = (cls.from_config(config) for cls in pair)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    if state == "set":
        assert dataclasses.asdict(mine) != dataclasses.asdict(pair[0]())


# -------------------------------------------------------------- the tier


class Side:
    """One package's router, membership, stubs, errors and chaos tier."""

    def __init__(self, name: str) -> None:
        self.jax = name == "jax"
        self.rt = jrouter if self.jax else trouter
        self.ms = jms if self.jax else tms
        self.stub_cls = JStub if self.jax else TStub
        self.chaos = jchaos if self.jax else tchaos
        self.errors = jerrors if self.jax else terrors


class Tier:
    """A router over named stubs (tokens=3, fast), registered with roles,
    each announced UP once; ``beat`` feeds membership directly."""

    def __init__(self, side: Side, stubs: dict, roles: dict | None = None, **cfg) -> None:
        self.side = side
        self.router = side.rt.Router(side.rt.RouterConfig(**cfg))
        self.stubs = {}
        self.seq: dict[str, int] = {}
        self.roles = roles or {}
        for rid, kw in stubs.items():
            stub = side.stub_cls(rid, **{"tokens": 3, "token_interval_s": 0.001, **kw})
            self.stubs[rid] = stub
            self.router.add_replica(side.rt.LocalReplica(rid, stub),
                                    role=self.roles.get(rid))
            self.beat(rid)

    def beat(self, rid: str, state: str = "UP", age: float = 0.0, **fields) -> None:
        self.seq[rid] = self.seq.get(rid, 0) + 1
        hb = self.side.ms.Heartbeat(rid, self.seq[rid], state=state,
                                    role=self.roles.get(rid, "unified"), **fields)
        self.router.membership.observe(hb, now=time.monotonic() - age)

    def affine(self, rid: str, tag: str) -> str:
        for i in range(400):
            prompt = f"{tag}{i} shared-system-prefix"
            if self.router._candidates_for(prompt)[0][:1] == [rid]:
                return prompt
        raise AssertionError(f"no prompt affine to {rid}")

    def tried(self, prompt) -> list[str]:
        subs = [(s["t"], rid) for rid, stub in self.stubs.items()
                for s in stub.submissions if s["prompt"] == prompt]
        return [rid for _, rid in sorted(subs)]

    def stop(self) -> None:
        self.router.stop()


def outcome(fut) -> tuple:
    try:
        r = fut.result(timeout=TIMEOUT)
    except Exception as exc:  # the type is the outcome
        return ("error", type(exc).__name__)
    return ("ok", r.replica_id, r.finish_reason, len(r.token_ids))


def submit(tier: Tier, prompt, **kw) -> tuple:
    """A submit's terminal outcome, refused at admission or settled."""
    try:
        fut = tier.router.submit(prompt, deadline=TIMEOUT, **kw)
    except Exception as exc:
        return ("refused", type(exc).__name__)
    return outcome(fut)


def wait_for(pred, what: str) -> None:
    end = time.monotonic() + TIMEOUT
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def summary(tier: Tier, prompts: list) -> dict:
    """Tries and outcomes per request, the counters, and the terminal
    audit: every stub's requests settled exactly once."""
    for stub in tier.stubs.values():
        wait_for(lambda s=stub: not s._live, f"{stub.replica_id} to settle")
        assert stub.double_terminals == []
    counters = tier.router._counters()
    return {"tried": [tier.tried(p) for p in prompts], "counters": counters}


def _run(scenario):
    outs = []
    for name in ("jax", "port"):
        side = Side(name)
        outs.append(scenario(side))
    assert outs[1] == outs[0]
    return outs[1]


def test_kill_fails_over_and_down_stops_routes():
    def scenario(side):
        tier = Tier(side, {"a": {"first_token_delay_s": LONG}, "b": {}, "c": {}})
        try:
            p1, p2, p3 = (tier.affine("a", t) for t in ("k1-", "k2-", "k3-"))
            fut = tier.router.submit(p1, deadline=TIMEOUT)
            tier.stubs["a"].kill()  # in flight before its first token
            first = outcome(fut)
            second = submit(tier, p2)  # a still UP in membership: refused at admission
            tier.beat("a", state="DOWN")
            third = submit(tier, p3)
            return {"outcomes": [first, second, third],
                    **summary(tier, [p1, p2, p3]), "terminals": tier.stubs["a"].terminals}
        finally:
            tier.stop()

    out = _run(scenario)
    assert out["outcomes"][0][:3] == ("ok", "b", "length")
    assert out["counters"]["failovers_total"] == 1
    assert len(out["tried"][2]) == 1 and out["tried"][2] != ["a"]


def test_wedge_fails_over_and_wedged_is_never_routed():
    def scenario(side):
        tier = Tier(side, {"a": {"first_token_delay_s": LONG, "supervisor_detect_s": 0.01},
                           "b": {}})
        try:
            p1, p2 = tier.affine("a", "w1-"), tier.affine("a", "w2-")
            fut = tier.router.submit(p1, deadline=TIMEOUT)
            tier.stubs["a"].wedge()
            first = outcome(fut)
            tier.beat("a", state="WEDGED")
            second = submit(tier, p2)
            return {"outcomes": [first, second], **summary(tier, [p1, p2])}
        finally:
            tier.stop()

    out = _run(scenario)
    assert out["tried"] == [["a", "b"], ["b"]]


def test_drain_finishes_in_flight_and_takes_nothing_new():
    def scenario(side):
        tier = Tier(side, {"a": {"first_token_delay_s": LONG}, "b": {}})
        try:
            p1, p2, p3 = (tier.affine("a", t) for t in ("d1-", "d2-", "d3-"))
            fut = tier.router.submit(p1, deadline=TIMEOUT)
            tier.stubs["a"].drain()
            second = submit(tier, p2)  # refused by a at admission, served by b
            tier.beat("a", state="DRAINING")
            third = submit(tier, p3)  # a is not a candidate any more
            tier.router.cancel(fut.request_id)  # the in-flight one ends on a
            first = outcome(fut)
            return {"outcomes": [first, second, third], **summary(tier, [p1, p2, p3])}
        finally:
            tier.stop()

    out = _run(scenario)
    assert out["outcomes"][0][:3] == ("ok", "a", "cancel")
    assert out["tried"] == [["a"], ["b"], ["b"]]


def test_revive_takes_routes_back():
    def scenario(side):
        tier = Tier(side, {"a": {}, "b": {}})
        try:
            p = tier.affine("a", "r-")
            tier.stubs["a"].kill()
            tier.beat("a", state="DOWN")
            before = submit(tier, p)
            tier.stubs["a"].revive()
            tier.beat("a")
            after = submit(tier, p)
            return {"outcomes": [before, after],
                    "counters": tier.router._counters(), "state": tier.router.health_check()["status"]}
        finally:
            tier.stop()

    out = _run(scenario)
    assert [o[1] for o in out["outcomes"]] == ["b", "a"]


def test_heartbeat_partition_and_last_resort():
    """a's beats stop arriving (a ``router.heartbeat`` fault drops each,
    counted by its announcer), so its last one ages into SUSPECT: routes
    go to the UP replica. When every replica's last beat is old, the
    SUSPECT pool serves as a last resort, counted."""

    class ToRouter:
        def __init__(self, tier, age):
            self.tier, self.age = tier, age

        def publish(self, topic, payload, metadata=None):
            hb = self.tier.side.ms.Heartbeat.from_json(payload)
            self.tier.router.membership.observe(hb, now=time.monotonic() - self.age)

    def scenario(side):
        tier = Tier(side, {"a": {}, "b": {}})
        try:
            p, q = tier.affine("b", "hb-"), tier.affine("a", "ha-")
            tier.router.remove_replica("a")
            tier.router.add_replica(side.rt.LocalReplica("a", tier.stubs["a"]))
            ann = side.ms.ReplicaAnnouncer("a", tier.stubs["a"], ToRouter(tier, 5.0),
                                           interval_s=99.0)
            ann.beat()  # delivered, but 5 s ago: a is SUSPECT
            with side.chaos.active(side.chaos.ChaosInjector(101, {"router.heartbeat": 1.0})):
                dropped = [ann.beat() for _ in range(3)]
            states = [tier.router.membership.state_of(r) for r in ("a", "b")]
            routed = [submit(tier, p), submit(tier, q)]
            for rid in ("a", "b"):
                tier.beat(rid, age=5.0)  # both beats old: everything SUSPECT
            last = submit(tier, q)
            tier.beat("a")
            healed = submit(tier, q)
            return {"dropped": (dropped, ann.dropped_beats), "states": states,
                    "outcomes": routed + [last, healed], **summary(tier, [p, q])}
        finally:
            tier.stop()

    out = _run(scenario)
    assert out["states"] == ["SUSPECT", "UP"]
    assert out["dropped"] == ([False, False, False], 3)
    assert [o[1] for o in out["outcomes"]] == ["b", "b", "a", "a"]
    assert out["counters"]["last_resort_routes_total"] == 1


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_route_faults_walk_the_candidates(seed):
    def scenario(side):
        tier = Tier(side, {"a": {}, "b": {}, "c": {}})
        try:
            prompts = [f"fault {seed} request {i}" for i in range(16)]
            with side.chaos.active(side.chaos.ChaosInjector(seed, {"router.route": 0.45})) as inj:
                outs = [submit(tier, p) for p in prompts]
                faults = inj.stats()
            return {"outcomes": outs, "faults": faults, **summary(tier, prompts)}
        finally:
            tier.stop()

    out = _run(scenario)
    assert any(len(t) == 1 for t in out["tried"])
    assert out["faults"]["router.route"]["faults"] > 0


@pytest.mark.parametrize("faulted", [False, True], ids=["hit", "claim-fault"])
def test_keyed_duplicate_fast_path(faulted):
    """The owner of a key is tried first for its duplicate even once the
    owner's load would spill a cold walk; a ``router.claim`` fault falls
    back to the cold walk (the replica's registry, not the hint, is the
    exactly-once authority)."""

    def scenario(side):
        tier = Tier(side, {"a": {}, "b": {}}, spill_wait_s=1.0)
        try:
            p = tier.affine("a", "key-")
            owner = submit(tier, p, idempotency_key="k1")
            tier.beat("a", queue_wait_s=5.0)  # a is now past the spill bound
            if faulted:
                with side.chaos.active(side.chaos.ChaosInjector(202, {"router.claim": 1.0},
                                                                max_faults=1)):
                    dup = submit(tier, p, idempotency_key="k1")
            else:
                dup = submit(tier, p, idempotency_key="k1")
            return {"outcomes": [owner, dup], **summary(tier, [p])}
        finally:
            tier.stop()

    out = _run(scenario)
    assert out["tried"] == [["a", "b" if faulted else "a"]]


def test_hedge_wins_and_cancels_the_primary():
    def scenario(side):
        tier = Tier(side, {"a": {"first_token_delay_s": LONG}, "b": {}},
                    hedge_delay_s=0.02, hedge_from_p99=False)
        try:
            p = tier.affine("a", "hedge-")
            frames = []
            res = outcome(tier.router.submit(p, deadline=TIMEOUT,
                                             stream_cb=lambda t, s, d: frames.append(d)))
            wait_for(lambda: tier.stubs["a"].terminals, "the primary's cancel")
            return {"outcome": res, "frames": frames, "terminals": tier.stubs["a"].terminals,
                    **summary(tier, [p])}
        finally:
            tier.stop()

    out = _run(scenario)
    assert out["outcome"][1] == "b" and out["counters"]["hedges_total"] == 1
    assert out["frames"] == [False, False, False, True]
    assert out["terminals"] == {1: "cancel"}


def test_role_split_tier_hands_off_and_degrades():
    roles = {"p": "prefill", "d1": "decode", "d2": "decode"}

    def scenario(side):
        tier = Tier(side, {"p": {}, "d1": {}, "d2": {}}, roles=roles)
        try:
            prompts = [f"split request {i}" for i in range(4)]
            outs = [submit(tier, q) for q in prompts[:2]]
            tier.stubs["p"].kill()  # prefill refuses: decode re-prefills
            outs += [submit(tier, q) for q in prompts[2:]]
            tier.beat("p", state="DOWN")  # no prefill pool: unified routing
            tail = "split request tail"
            outs.append(submit(tier, tail))
            return {"outcomes": outs, "routerz_roles": tier.router.routerz()["roles_present"],
                    **summary(tier, prompts + [tail])}
        finally:
            tier.stop()

    out = _run(scenario)
    assert [t[0] for t in out["tried"][:2]] == ["p", "p"]
    assert out["counters"]["handoffs_total"] == 2
    assert out["counters"]["handoff_degraded_total"] == 2
    assert out["routerz_roles"] == ["decode"]


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items() if k not in ("replicas", "routes_by_replica")}
    return None


def test_routerz_and_health_have_the_reference_keys():
    def scenario(side):
        tier = Tier(side, {"a": {}, "b": {}}, hedge_delay_s=0.5)
        try:
            submit(tier, "routerz probe")
            z = tier.router.routerz()
            return {"routerz": _keys(z), "replica": sorted(z["replicas"]["a"]),
                    "health": _keys(tier.router.health_check())}
        finally:
            tier.stop()

    _run(scenario)


# ------------------------------------------------------------ error identity


class ScriptedHandle:
    """A replica whose every attempt the test settles by hand."""

    def __init__(self, rid: str) -> None:
        self.replica_id = rid
        self.futures: list = []

    def submit(self, prompt, **kw):
        fut = concurrent.futures.Future()
        fut.request_id = len(self.futures) + 1
        self.futures.append(fut)
        return fut

    def cancel(self, request_id) -> None:
        pass


@pytest.mark.parametrize("make", [
    lambda: terrors.ErrorServiceUnavailable("restarting", retry_after=0.1),
    lambda: terrors.ErrorTooManyRequests("shed", retry_after=0.1),
    lambda: terrors.CircuitBreakerError("replica-a"),
    lambda: tchaos.ChaosFault("router.route", 1),
    lambda: ConnectionError("transport reset"),
    lambda: terrors.ErrorStaleEpoch(),
], ids=["503", "429", "breaker", "chaos", "connection", "stale-epoch"])
def test_each_retriable_class_fails_over(make):
    exc = make()
    assert isinstance(exc, trouter.RETRIABLE_ERRORS)
    router = trouter.Router(trouter.RouterConfig())
    a, b = ScriptedHandle("a"), ScriptedHandle("b")
    for h in (a, b):
        router.add_replica(h)
        router.membership.observe(tms.Heartbeat(h.replica_id, 1))
    try:
        prompt = next(f"e{i}" for i in range(400) if router._candidates_for(f"e{i}")[0][0] == "a")
        fut = router.submit(prompt)
        a.futures[0].set_exception(exc)
        wait_for(lambda: b.futures, "the failover attempt")
        b.futures[0].set_result(type("R", (), {"finish_reason": "length"})())
        assert fut.result(TIMEOUT).replica_id == "b"
        assert router.failovers_total == 1
    finally:
        router.stop()


def test_reference_error_classes_are_not_retriable_to_the_port():
    """Error identity: a reference error reaching a port router is not
    retriable there, which is why the port's tests drive the port's stub."""
    assert not issubclass(jerrors.ErrorServiceUnavailable, trouter.RETRIABLE_ERRORS)
    assert {c.__name__ for c in trouter.RETRIABLE_ERRORS} == \
        {c.__name__ for c in jrouter.RETRIABLE_ERRORS}
    router = trouter.Router(trouter.RouterConfig())
    a, b = ScriptedHandle("a"), ScriptedHandle("b")
    for h in (a, b):
        router.add_replica(h)
        router.membership.observe(tms.Heartbeat(h.replica_id, 1))
    try:
        fut = router.submit("identity")
        first = a if a.futures else b
        first.futures[0].set_exception(jerrors.ErrorServiceUnavailable("x", retry_after=0.1))
        with pytest.raises(jerrors.ErrorServiceUnavailable):
            fut.result(TIMEOUT)
        assert router.failovers_total == 0
    finally:
        router.stop()


def test_attempt_spans_match_the_reference():
    """With a tracer, each attempt is a ``router.attempt`` client span under
    the caller's span, with the request, replica, kind and outcome; a
    failover adds a second. The same spans on both sides."""
    from gofr_tpu.tracing import export as jexport
    from gofr_tpu.tracing import trace as jtrace
    from gofr_tpu_torch.tracing import export as texport
    from gofr_tpu_torch.tracing import trace as ttrace

    def scenario(side):
        export, trace = (jexport, jtrace) if side.jax else (texport, ttrace)
        exporter = export.InMemoryExporter()
        tracer = trace.Tracer("router", export.SimpleSpanProcessor(exporter))
        tier = Tier(side, {"a": {"first_token_delay_s": LONG}, "b": {}})
        tier.router.use_tracer(tracer)
        try:
            p = tier.affine("a", "traced-")
            caller = tracer.start_span("caller", activate=False)
            fut = tier.router.submit(p, deadline=TIMEOUT, trace_ctx=caller)
            tier.stubs["a"].kill()
            res = outcome(fut)
            caller.end()
            spans = [s for s in exporter.spans if s.name == "router.attempt"]
            return {"outcome": res, "spans": sorted(
                (s.kind, s.parent_id == caller.span_id, s.trace_id == caller.trace_id,
                 tuple(sorted((k, v) for k, v in s.attributes.items() if k != "request.id")))
                for s in spans)}
        finally:
            tier.stop()

    out = _run(scenario)
    assert len(out["spans"]) == 2 and all(s[1] and s[2] for s in out["spans"])
