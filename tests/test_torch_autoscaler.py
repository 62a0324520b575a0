"""The port's autoscaler and pool driver against the JAX package's, on the
CPU, over stub replicas (each side's own ``StubReplicaEngine``) behind each
side's router, membership fed directly and every round driven by
``Autoscaler.tick(now=)`` on a scripted clock:

- a scripted queue-wait and HBM signal gives the reference's decision list
  (direction, role, replica ids, target, signal), with hysteresis,
  cooldown and the min/max bounds;
- a ``scale.decision`` fault skips the round and is counted;
- ``observe_notice`` backfills at once, past the hysteresis and the
  cooldown, with on-demand capacity;
- ``SimulatedPoolDriver.notice`` under a ``replica.reclaim`` fault is a
  lost notice: the replica keeps serving;
- a scale-down drains its victim and reaps it once idle: a request in
  flight on it finishes, nothing is killed.
"""

import time

import pytest

from gofr_tpu import chaos as jchaos
from gofr_tpu.serving import autoscaler as jauto
from gofr_tpu.serving import membership as jms
from gofr_tpu.serving import router as jrouter
from gofr_tpu.testutil.replica import StubReplicaEngine as JStub

pytest.importorskip("torch")

from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch.serving import autoscaler as tauto  # noqa: E402
from gofr_tpu_torch.serving import membership as tms  # noqa: E402
from gofr_tpu_torch.serving import router as trouter  # noqa: E402
from gofr_tpu_torch.testutil.replica import StubReplicaEngine as TStub  # noqa: E402

TIMEOUT = 10.0
SIDES = {"jax": (jauto, jms, jrouter, JStub, jchaos), "port": (tauto, tms, trouter, TStub, tchaos)}


class Harness:
    """A router and a simulated pool of stubs, one side's modules."""

    def __init__(self, name: str, **cfg) -> None:
        self.auto, self.ms, rt, stub_cls, self.chaos = SIDES[name]
        self.router = rt.Router(rt.RouterConfig())
        self.stubs: dict = {}
        self.seq: dict = {}

        def factory(role, rid, preemptible=False):
            stub = stub_cls(rid, tokens=3, token_interval_s=0.001)
            self.stubs[rid] = stub
            handle = rt.LocalReplica(rid, stub, role=role)
            handle.preemptible = preemptible
            return handle

        self.driver = self.auto.SimulatedPoolDriver(self.router, factory)
        conf = dict(min_replicas=1, max_replicas=3, scale_up_wait_s=1.0, scale_down_wait_s=0.1,
                    up_stable_s=0.3, down_stable_s=0.5, cooldown_s=0.4)
        conf.update(cfg)
        self.scaler = self.auto.Autoscaler(self.router, self.driver,
                                           self.auto.AutoscalerConfig(**conf))

    def beat(self, wait: float = 0.0, hbm: float | None = None) -> None:
        for rid in self.driver.replica_ids("unified"):
            self.seq[rid] = self.seq.get(rid, 0) + 1
            self.router.membership.observe(self.ms.Heartbeat(
                rid, self.seq[rid], queue_wait_s=wait, hbm_free_frac=hbm))

    def decisions(self) -> list:
        return [{k: v for k, v in d.items() if k != "t"} for d in self.scaler.decisions]

    def counters(self) -> dict:
        snap = self.scaler.snapshot()
        return {k: snap[k] for k in ("scale_ups_total", "scale_downs_total",
                                     "decisions_skipped_total", "notices_observed_total")}

    def stop(self) -> None:
        self.router.stop()


def _both(scenario) -> dict:
    outs = [scenario(Harness(name)) for name in SIDES]
    assert outs[1] == outs[0]
    return outs[1]


# the signal, one tick every 0.1 s of the scripted clock: pressure, a blip
# shorter than up_stable_s, HBM pressure, then idle to the floor
SIGNAL = ([(2.0, None)] * 12 + [(0.5, None)] * 2 + [(2.0, None)] + [(0.5, None)] * 2
          + [(0.0, 0.01)] * 10 + [(0.0, None)] * 30)


def test_decisions_match_the_reference():
    def scenario(h):
        try:
            h.driver.scale_up("unified", 1)
            pools = []
            for i, (wait, hbm) in enumerate(SIGNAL):
                h.beat(wait, hbm)
                h.scaler.tick(now=100.0 + 0.1 * i)
                pools.append(len(h.driver.replica_ids("unified")))
            return {"decisions": h.decisions(), "pools": pools, "counters": h.counters(),
                    "final": h.driver.replica_ids("unified")}
        finally:
            h.stop()

    out = _both(scenario)
    dirs = [d["direction"] for d in out["decisions"]]
    assert dirs.count("up") == 2 and "down" in dirs
    assert max(out["pools"]) == 3 and out["pools"][-1] == 1  # the max and the min hold
    assert out["pools"][:3] == [1, 1, 1]  # hysteresis: no action before up_stable_s


def test_scale_decision_fault_skips_the_round():
    def scenario(h):
        try:
            h.driver.scale_up("unified", 1)
            with h.chaos.active(h.chaos.ChaosInjector(202, {"scale.decision": 1.0},
                                                       max_faults=3)):
                for i in range(8):
                    h.beat(2.0)
                    h.scaler.tick(now=10.0 + 0.1 * i)
            return {"decisions": h.decisions(), "counters": h.counters(),
                    "pool": h.driver.replica_ids("unified")}
        finally:
            h.stop()

    out = _both(scenario)
    assert out["counters"]["decisions_skipped_total"] == 3
    # the pressure window opened only at the first unfaulted round
    assert [d["direction"] for d in out["decisions"]] == ["up"]


def test_notice_backfills_past_hysteresis():
    def scenario(h):
        h.scaler.config.up_stable_s = h.scaler.config.cooldown_s = 3600.0
        try:
            h.driver.scale_up("unified", 1)
            (spot,) = h.driver.scale_up("unified", 1, preemptible=True)
            delivered = h.driver.notice(spot, deadline_s=1.0)
            return {"delivered": delivered, "decisions": h.decisions(),
                    "counters": h.counters(), "pool": h.driver.replica_ids("unified"),
                    "preemptible": h.driver.preemptible_ids(), "draining": h.scaler.snapshot()["draining"]}
        finally:
            h.stop()

    out = _both(scenario)
    assert out["delivered"] and out["counters"]["notices_observed_total"] == 1
    assert [d["direction"] for d in out["decisions"]] == ["backfill"]
    assert out["preemptible"] == [] and len(out["pool"]) == 2


@pytest.mark.parametrize("seed", (101, 202, 303))
def test_lost_notice_keeps_the_replica_serving(seed):
    def scenario(h):
        try:
            (spot,) = h.driver.scale_up("unified", 1, preemptible=True)
            with h.chaos.active(h.chaos.ChaosInjector(seed, {"replica.reclaim": 1.0})):
                delivered = h.driver.notice(spot, deadline_s=2.0)
            h.beat()
            r = h.router.submit("still serving", deadline=TIMEOUT).result(TIMEOUT)
            return {"delivered": delivered, "dropped": h.driver.notices_dropped_total,
                    "notices": h.driver.notices_total, "pool": h.driver.replica_ids("unified"),
                    "state": h.stubs[spot].state, "served_by": r.replica_id,
                    "counters": h.counters()}
        finally:
            h.stop()

    out = _both(scenario)
    assert (out["delivered"], out["dropped"], out["notices"]) == (False, 1, 0)
    assert out["state"] == "UP" and out["served_by"] == out["pool"][0]


def test_scale_down_drains_and_reaps_never_kills():
    def scenario(h):
        try:
            h.driver.scale_up("unified", 2)
            victim = sorted(h.driver.replica_ids("unified"))[0]
            stub = h.stubs[victim]
            stub.tokens, stub.token_interval_s = 20, 0.01
            fut = stub.submit("in flight on the victim")  # ~0.2 s of tokens
            t, rounds = 50.0, []
            while victim in h.stubs and h.driver.handle(victim) is not None:
                h.beat(0.0)
                h.scaler.tick(now=t)
                rounds.append((stub.state, len(h.driver.replica_ids("unified"))))
                t += 0.1
                assert t < 50.0 + TIMEOUT * 10
                time.sleep(0.01)
            r = fut.result(TIMEOUT)
            return {"decisions": h.decisions(), "result": (r.finish_reason, len(r.token_ids)),
                    "terminals": stub.terminals, "killed": stub._killed.is_set(),
                    "victim": victim, "first": rounds[0], "removed": victim not in
                    h.router.membership.snapshot()}
        finally:
            h.stop()

    out = _both(scenario)
    assert out["result"] == ("length", 20) and out["terminals"] == {1: "length"}
    assert not out["killed"] and out["removed"]
    assert [d["direction"] for d in out["decisions"]] == ["down"]
