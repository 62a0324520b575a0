"""Rank functions of ``test_torch_sick_chip_mesh.py``: the port's device
client over a mesh of gloo CPU ranks, case by case as the reference's
``tests/test_sick_chip.py`` drives its client over an 8-device CPU mesh.

:func:`sick_chip_world` runs every case in order on each rank of one world
and returns this rank's record of each: the values the reference's test
asserts on, which the test holds to the same values read from the
reference's client. The fault the reference injects into its executable
lives on device 0: here it is injected into rank 0's executable only, and
the other ranks learn of it through the client's agreement. No JAX in a
rank.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import torch

from gofr_tpu_torch.datasource.tpu import TPUClient
from gofr_tpu_torch.datasource.tpu.client import TPUError
from gofr_tpu_torch.parallel.collectives import psum
from gofr_tpu_torch.parallel.sharding import NamedSharding, P


def flaky(client: TPUClient, name: str, failures: int) -> None:
    """Fail the next ``failures`` runs of ``name`` on rank 0 (the sick
    device), as the reference's ``_FlakyExecutable``."""
    if client._rank != 0:
        return
    exe = client._executables[name]
    real, state = exe.run, {"remaining": failures}

    def run(args):
        if state["remaining"] > 0:
            state["remaining"] -= 1
            raise RuntimeError("injected device failure (wedged chip)")
        return real(args)

    exe.run = run


def _client(threshold: int, cooldown: float, spec: str = "dp=8") -> TPUClient:
    client = TPUClient(mesh_spec=spec, breaker_threshold=threshold,
                       breaker_cooldown_s=cooldown, device="cpu")
    client.connect()
    return client


def _error(fn) -> tuple[int, str]:
    try:
        fn()
    except TPUError as exc:
        return exc.status_code, str(exc)
    return 0, ""


def _health(client: TPUClient) -> dict:
    d = client.health_check()
    return {"status": d["status"], "excluded": d["details"].get("excluded_devices"),
            "discovered": d["details"].get("devices_discovered"),
            "count": d["details"]["device_count"], "mesh": d["details"]["mesh"]}


def breaker_trips_and_call_recovers() -> dict:
    client = _client(3, 0.5)
    client._probe_device = lambda d: d.id != 0
    client.compile("inc", lambda x: x + 1, torch.zeros(4))
    flaky(client, "inc", 10)
    rec: dict[str, Any] = {"errors": [_error(lambda: client.execute("inc", torch.ones(4)))
                                      for _ in range(2)],
                           "count_before": client.device_count()}
    rec["out"] = client.execute("inc", torch.ones(4), block=True).tolist()
    rec["count_after"] = client.device_count()
    rec["health"] = _health(client)
    rec["out2"] = client.execute("inc", torch.zeros(4), block=True).tolist()
    client.close()
    return rec


def cooldown_probe_restores_full_mesh() -> dict:
    client = _client(3, 0.5)
    client._probe_device = lambda d: d.id != 0
    client.compile("inc", lambda x: x + 1, torch.zeros(2))
    flaky(client, "inc", 3)
    rec: dict[str, Any] = {"errors": [_error(lambda: client.execute("inc", torch.ones(2)))[0]
                                      for _ in range(2)]}
    rec["out"] = client.execute("inc", torch.ones(2), block=True).tolist()
    rec["status"] = client.health_check()["status"]
    time.sleep(0.6)  # past the cooldown
    rec["out_restored"] = client.execute("inc", torch.ones(2), block=True).tolist()
    rec["count"] = client.device_count()
    rec["status_restored"] = client.health_check()["status"]
    client.close()
    return rec


def mesh_bound_shardings_fail_loudly_on_failover() -> dict:
    client = _client(1, 60)
    client._probe_device = lambda d: d.id != 0
    bound = NamedSharding(client.mesh(), P("dp"))
    client.compile("sharded", lambda x: x * 2, torch.zeros(8, 4),
                   in_shardings=bound, out_shardings=bound)
    flaky(client, "sharded", 1)
    rec = {"error": _error(lambda: client.execute("sharded", torch.ones(8, 4)))}
    client.close()
    return rec


def callable_shardings_survive_failover() -> dict:
    client = _client(1, 60)
    client._probe_device = lambda d: d.id != 0
    client.compile("sharded", lambda x: x * 2, torch.zeros(56, 4),
                   in_shardings=lambda mesh: NamedSharding(mesh, P("dp")),
                   out_shardings=lambda mesh: NamedSharding(mesh, P("dp")))
    flaky(client, "sharded", 1)
    # batch 56 divides by both dp=8 and the shrunk dp=7
    out = client.execute("sharded", torch.ones(56, 4), block=True)
    rec = {"shape": list(out.shape), "all_two": bool(torch.all(out == 2.0)),
           "count": client.device_count(),
           "on_mesh_but_rank_0": (client.mesh() is not None) == (client._rank != 0)}
    client.close()
    return rec


def all_devices_excluded_is_terminal() -> dict:
    client = _client(1, 60, spec="dp=-1")
    client._all_devices = client._all_devices[:1]
    client._rebuild_mesh()
    client._probe_device = lambda d: False  # every device is sick
    client.compile("inc", lambda x: x + 1, torch.zeros(2))
    flaky(client, "inc", 99)
    rec = {"error": _error(lambda: client.execute("inc", torch.ones(2)))[1]}
    client.close()
    return rec


def restore_keeps_mesh_bound_executables() -> dict:
    client = _client(1, 0.2)
    client._probe_device = lambda d: d.id != 0
    full = client.mesh()

    def bound():
        s = NamedSharding(client.mesh(), P("dp"))
        client.compile("bound", lambda x: x + 1, torch.zeros(8), in_shardings=s, out_shardings=s)

    bound()
    client.compile("plain", lambda x: x * 3, torch.zeros(2))
    # trip on the plain executable: a shrink, and "bound" is evicted
    flaky(client, "plain", 1)
    rec: dict[str, Any] = {"out": client.execute("plain", torch.ones(2), block=True).tolist(),
                           "count": client.device_count()}
    time.sleep(0.25)  # the cooldown: the next execute restores the full set
    client._probe_device = lambda d: True  # the device recovered
    client.execute("plain", torch.ones(2), block=True)
    rec["count_restored"] = client.device_count()
    rec["same_mesh_object"] = client.mesh() is full
    bound()
    rec["bound"] = client.execute("bound", torch.ones(8), block=True).tolist()
    client.close()
    return rec


def probe_threads_bounded_with_wedged_device() -> dict:
    client = _client(1, 999)
    hang = threading.Event()  # never set until the end: device 0's probe blocks

    def probe(d):
        if d.id == 0:
            hang.wait()  # a wedged device: hangs, never raises
        return True

    client._probe_device = probe
    baseline = threading.active_count()
    sweeps = [client._probe_devices_safely(client._devices, timeout_s=0.2) for _ in range(5)]
    grown = threading.active_count() - baseline
    again = client._probe_devices_safely(client._devices, timeout_s=0.2)
    rec = {"sweeps": sweeps, "bounded": grown <= len(client._devices), "again": again,
           "bounded_again": threading.active_count() - baseline <= len(client._devices)}
    hang.set()
    client.close()
    return rec


def stale_epoch_failure_skips_breaker() -> dict:
    client = _client(1, 999)
    probed: list[int] = []

    def probe(d):
        probed.append(d.id)
        return d.id != 0

    client._probe_device = probe
    client.compile("inc", lambda x: x + 1, torch.zeros(4))
    flaky(client, "inc", 1)
    client.execute("inc", torch.ones(4), block=True)  # a trip: device 0 out, the epoch moves
    rec: dict[str, Any] = {"count": client.device_count()}
    epoch_after_trip = client._epoch
    probed.clear()
    # a straggler reports a failure observed on the OLD epoch: no probe, no
    # new exclusion, the call succeeds on the current mesh
    out = client._on_execute_failure("inc", (torch.ones(4),), True,
                                     RuntimeError("stale failure from old mesh"),
                                     epoch=epoch_after_trip - 1)
    rec.update(out=out.tolist(), probed=list(probed), count_after=client.device_count())
    client.close()
    return rec


# -------------------------------------------------------- the port's own
def model_axes_shrink_and_two_axis_gather() -> dict:
    """tp=4 x dp=2 over 8 ranks: an output split over both axes gathers in
    local_index's order; losing rank 0 refits to tp=4, dp=1 (the
    reference's policy) over ranks 1-4, and the ranks left outside the
    mesh (0 and 5-7) still return the result."""
    client = _client(1, 999, spec="dp=2,tp=4")
    client._probe_device = lambda d: d.id != 0
    x = torch.arange(64.0).reshape(4, 16)
    s = lambda mesh: NamedSharding(mesh, P("dp", "tp"))  # noqa: E731
    client.compile("double", lambda t: t * 2, x, in_shardings=s, out_shardings=s)
    rec: dict[str, Any] = {"healthy": torch.equal(client.execute("double", x), x * 2)}
    flaky(client, "double", 1)
    out = client.execute("double", x)
    rec.update(after=torch.equal(out, x * 2), count=client.device_count(),
               mesh=client.health_check()["details"]["mesh"])
    client.close()
    return rec


def a_collective_in_fn_is_refused_at_compile() -> dict:
    client = _client(3, 30)
    mesh = client.mesh()
    rec = {"error": _error(lambda: client.compile("sum", lambda t: psum(t, mesh, "dp"),
                                                  torch.zeros(2)))[1]}
    health = client.health_check()
    rec.update(status=health["status"], last_error="refused" in health["details"]["last_error"])
    client.compile("inc", lambda t: t + 1, torch.zeros(2))
    rec["meta"] = {k: client._exec_meta["inc"][k] for k in ("captured", "collectives", "mesh")}
    client.close()
    return rec


CASES = (
    breaker_trips_and_call_recovers,
    cooldown_probe_restores_full_mesh,
    mesh_bound_shardings_fail_loudly_on_failover,
    callable_shardings_survive_failover,
    all_devices_excluded_is_terminal,
    restore_keeps_mesh_bound_executables,
    probe_threads_bounded_with_wedged_device,
    stale_epoch_failure_skips_breaker,
    model_axes_shrink_and_two_axis_gather,
    a_collective_in_fn_is_refused_at_compile,
)


def sick_chip_world(device) -> dict:
    """Every case in order on this rank: {case name: record, "seconds": ...}."""
    out: dict[str, Any] = {}
    for case in CASES:
        t = time.perf_counter()
        out[case.__name__] = case()
        out.setdefault("seconds", {})[case.__name__] = time.perf_counter() - t
    return out
