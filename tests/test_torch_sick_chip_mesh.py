"""The port's device client over a mesh (``gofr_tpu_torch/datasource/tpu``,
``TPU_MESH`` over a world of ranks) against the JAX package's
``TPUClient`` over its 8-device CPU mesh: every mesh case of
``tests/test_sick_chip.py``.

One world of 8 gloo ranks on the CPU runs the port's side of every case
(``tests/torch_sick_chip_cases.py``, no JAX in a rank); each rank's record
must equal every other rank's (the breaker, the exclusion, the rebuilt
mesh and the result are agreed over the world) and the reference's record
of the same case, read here from its client: the typed 503s below the
threshold, the trip that excludes device 0 and the retried call's result,
DEGRADED naming device 0, the half-open restore, a mesh-bound executable
refused after the shrink while a callable-sharded one survives, all
devices excluded, bounded probe threads, the stale-epoch skip. The shrink
policy is a pure function, compared on both packages. Two cases are the
port's own: a two-axis mesh refitted by the policy, whose ranks left
outside still return the result, and a collective inside ``fn`` refused
at compile."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_sick_chip_cases as cases  # noqa: E402

from gofr_tpu.datasource.tpu import TPUClient as JTPUClient  # noqa: E402
from gofr_tpu.datasource.tpu.client import TPUError as JTPUError  # noqa: E402
from gofr_tpu.datasource.tpu.client import _shrink_spec as j_shrink_spec  # noqa: E402
from gofr_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from gofr_tpu_torch.datasource.tpu import TPUClient  # noqa: E402
from gofr_tpu_torch.datasource.tpu.client import _shrink_spec  # noqa: E402
from gofr_tpu_torch.parallel import world  # noqa: E402
from gofr_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402

RANKS = 8


@pytest.fixture(scope="module")
def port():
    """Every rank's records, from one world running every case in order."""
    ranks = world.run_spmd(cases.sick_chip_world, RANKS, backend="gloo", device="cpu",
                           timeout_s=240)
    return {name: [r[name] for r in ranks] for name in ranks[0] if name != "seconds"}


def _agreed(port, name: str) -> dict:
    records = port[name]
    assert all(r == records[0] for r in records), records
    return records[0]


class _Flaky:
    """The reference's ``_FlakyExecutable``: fails the first N calls."""

    def __init__(self, real, failures: int) -> None:
        self.real, self.remaining = real, failures

    def __call__(self, *args):
        if self.remaining > 0:
            self.remaining -= 1
            raise RuntimeError("injected device failure (wedged chip)")
        return self.real(*args)


def _ref(threshold: int, cooldown: float, spec: str = "dp=8") -> JTPUClient:
    client = JTPUClient(mesh_spec=spec, breaker_threshold=threshold, breaker_cooldown_s=cooldown)
    client.connect()
    return client


def _ref_error(fn) -> tuple[int, str]:
    try:
        fn()
    except JTPUError as exc:
        return exc.status_code, str(exc)
    return 0, ""


def _list(x) -> list:
    return np.asarray(x).tolist()


# tests/test_sick_chip.py:50
def test_breaker_trips_and_call_recovers(port):
    client = _ref(3, 0.5)
    client._probe_device = lambda d: d.id != 0
    client.compile("inc", lambda x: x + 1, jnp.zeros((4,), jnp.float32))
    client._executables["inc"] = _Flaky(client._executables["inc"], 10)
    want = {"errors": [list(_ref_error(lambda: client.execute("inc", jnp.ones((4,), jnp.float32))))
                       for _ in range(2)],
            "count_before": client.device_count()}
    want["out"] = _list(client.execute("inc", np.ones((4,), np.float32), block=True))
    want["count_after"] = client.device_count()
    d = client.health_check()
    want["health"] = {"status": d["status"], "excluded": d["details"]["excluded_devices"],
                      "discovered": d["details"]["devices_discovered"],
                      "count": d["details"]["device_count"], "mesh": d["details"]["mesh"]}
    want["out2"] = _list(client.execute("inc", np.zeros((4,), np.float32), block=True))
    got = _agreed(port, "breaker_trips_and_call_recovers")
    got["errors"] = [list(e) for e in got["errors"]]
    assert got == want
    assert want["health"]["excluded"] == [0] and want["count_after"] == 7


# tests/test_sick_chip.py:77
def test_cooldown_probe_restores_full_mesh(port):
    client = _ref(3, 0.5)
    client._probe_device = lambda d: d.id != 0
    client.compile("inc", lambda x: x + 1, jnp.zeros((2,), jnp.float32))
    client._executables["inc"] = _Flaky(client._executables["inc"], 3)
    want = {"errors": [_ref_error(lambda: client.execute("inc", jnp.ones((2,), jnp.float32)))[0]
                       for _ in range(2)]}
    want["out"] = _list(client.execute("inc", np.ones((2,), np.float32), block=True))
    want["status"] = client.health_check()["status"]
    time.sleep(0.6)
    want["out_restored"] = _list(client.execute("inc", np.ones((2,), np.float32), block=True))
    want["count"] = client.device_count()
    want["status_restored"] = client.health_check()["status"]
    assert _agreed(port, "cooldown_probe_restores_full_mesh") == want
    assert want["count"] == 8 and want["status_restored"] == "UP"


# tests/test_sick_chip.py:94
def test_mesh_bound_shardings_fail_loudly_on_failover(port):
    from jax.sharding import NamedSharding, PartitionSpec

    client = _ref(1, 60)
    client._probe_device = lambda d: d.id != 0
    client.compile("sharded", lambda x: x * 2, jnp.zeros((8, 4), jnp.float32),
                   in_shardings=NamedSharding(client.mesh(), PartitionSpec("dp")))
    client._executables["sharded"] = _Flaky(client._executables["sharded"], 1)
    want = _ref_error(lambda: client.execute("sharded", np.ones((8, 4), np.float32)))
    got = _agreed(port, "mesh_bound_shardings_fail_loudly_on_failover")
    assert tuple(got["error"]) == want and "recompile" in want[1]


# tests/test_sick_chip.py:114
def test_callable_shardings_survive_failover(port):
    from jax.sharding import NamedSharding, PartitionSpec

    client = _ref(1, 60)
    client._probe_device = lambda d: d.id != 0
    client.compile("sharded", lambda x: x * 2, jnp.zeros((56, 4), jnp.float32),
                   in_shardings=lambda mesh: NamedSharding(mesh, PartitionSpec("dp")))
    client._executables["sharded"] = _Flaky(client._executables["sharded"], 1)
    out = np.asarray(client.execute("sharded", np.ones((56, 4), np.float32), block=True))
    want = {"shape": list(out.shape), "all_two": bool(np.all(out == 2.0)),
            "count": client.device_count(), "on_mesh_but_rank_0": True}
    assert _agreed(port, "callable_shardings_survive_failover") == want
    assert want["count"] == 7 and want["all_two"]


# tests/test_sick_chip.py:134
def test_all_devices_excluded_is_terminal(port):
    client = _ref(1, 60, spec="dp=-1")
    client._all_devices = client._all_devices[:1]
    client._rebuild_mesh()
    client._probe_device = lambda d: False
    client.compile("inc", lambda x: x + 1, jnp.zeros((2,), jnp.float32))
    client._executables["inc"] = _Flaky(client._executables["inc"], 99)
    want = {"error": _ref_error(lambda: client.execute("inc", jnp.ones((2,), jnp.float32)))[1]}
    assert _agreed(port, "all_devices_excluded_is_terminal") == want
    assert "excluded" in want["error"]


# tests/test_sick_chip.py:147
@pytest.mark.parametrize("spec,n", [
    (dict(dp=2, tp=4), 7), (dict(tp=8), 7), (dict(dp=8), 5), (None, 3),
    (dict(dp=2, sp=2, tp=2), 5), (dict(pp=2, ep=3), 4), (dict(fsdp=4, tp=2), 1),
])
def test_shrink_spec_policy(spec, n):
    got = _shrink_spec(MeshSpec(**spec) if spec else None, n)
    want = j_shrink_spec(JMeshSpec(**spec) if spec else None, n)
    assert got.sizes() == want.sizes()
    s = _shrink_spec(MeshSpec(dp=2, tp=4), 7)
    assert (s.tp, s.dp) == (4, 1)
    s = _shrink_spec(MeshSpec(tp=8), 7)
    assert s.tp == 4 and s.dp == 1
    assert _shrink_spec(MeshSpec(dp=8), 5).dp == 5 and _shrink_spec(None, 3).dp == 3


# tests/test_sick_chip.py:180
def test_restore_keeps_mesh_bound_executables(port):
    from jax.sharding import NamedSharding, PartitionSpec

    client = _ref(1, 0.2)
    client._probe_device = lambda d: d.id != 0
    full = client.mesh()

    def bound():
        client.compile("bound", lambda x: x + 1, jnp.zeros((8,), jnp.float32),
                       in_shardings=NamedSharding(client.mesh(), PartitionSpec("dp")))

    bound()
    client.compile("plain", lambda x: x * 3, jnp.zeros((2,), jnp.float32))
    client._executables["plain"] = _Flaky(client._executables["plain"], 1)
    want = {"out": _list(client.execute("plain", np.ones((2,), np.float32), block=True)),
            "count": client.device_count()}
    time.sleep(0.25)
    client._probe_device = lambda d: True
    client.execute("plain", np.ones((2,), np.float32), block=True)
    want["count_restored"] = client.device_count()
    # the reference builds a new Mesh object over the same devices; the
    # port keeps the mesh of each device set, so the object itself returns
    want["same_mesh_object"] = client.mesh() == full
    bound()
    want["bound"] = _list(client.execute("bound", np.ones((8,), np.float32), block=True))
    assert _agreed(port, "restore_keeps_mesh_bound_executables") == want
    assert want["count_restored"] == 8


# tests/test_sick_chip.py:213
def test_probe_threads_bounded_with_wedged_device(port):
    client = _ref(1, 999)
    hang = threading.Event()

    def probe(d):
        if d.id == 0:
            hang.wait()
        return True

    client._probe_device = probe
    baseline = threading.active_count()
    sweeps = [client._probe_devices_safely(client._devices, timeout_s=0.2) for _ in range(5)]
    grown = threading.active_count() - baseline
    again = client._probe_devices_safely(client._devices, timeout_s=0.2)
    want = {"sweeps": sweeps, "bounded": grown <= len(client._devices), "again": again,
            "bounded_again": threading.active_count() - baseline <= len(client._devices)}
    hang.set()
    client.close()
    assert _agreed(port, "probe_threads_bounded_with_wedged_device") == want
    assert want["sweeps"] == [[0]] * 5 and want["bounded"]


# tests/test_sick_chip.py:245
def test_stale_epoch_failure_skips_breaker(port):
    client = _ref(1, 999)
    probed: list[int] = []

    def probe(d):
        probed.append(d.id)
        return d.id != 0

    client._probe_device = probe
    client.compile("inc", lambda x: x + 1, jnp.zeros((4,), jnp.float32))
    client._executables["inc"] = _Flaky(client._executables["inc"], 1)
    client.execute("inc", np.ones((4,), np.float32), block=True)
    want = {"count": client.device_count()}
    epoch_after_trip = client._epoch
    probed.clear()
    out = client._on_execute_failure("inc", (np.ones((4,), np.float32),), True,
                                     RuntimeError("stale failure from old mesh"),
                                     epoch=epoch_after_trip - 1)
    want.update(out=_list(out), probed=list(probed), count_after=client.device_count())
    client.close()
    assert _agreed(port, "stale_epoch_failure_skips_breaker") == want
    assert want["probed"] == [] and want["count_after"] == 7


# ------------------------------------------------------------- the port's own
def test_model_axes_shrink_and_ranks_outside_still_answer(port):
    got = _agreed(port, "model_axes_shrink_and_two_axis_gather")
    want_mesh = dict(zip(("dp", "fsdp", "pp", "sp", "ep", "tp"),
                         j_shrink_spec(JMeshSpec(dp=2, tp=4), 7).sizes()))
    assert got == {"healthy": True, "after": True, "count": 4, "mesh": want_mesh}


def test_a_collective_in_fn_is_refused_at_compile(port):
    got = _agreed(port, "a_collective_in_fn_is_refused_at_compile")
    assert got["error"].startswith("compilation of sum failed: psum: a collective is refused")
    assert "cannot be captured" in got["error"]
    assert got["status"] == "DEGRADED" and got["last_error"]
    assert got["meta"] == {"captured": False, "collectives": "refused",
                           "mesh": {"dp": 8, "fsdp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 1}}


def test_connect_without_a_world_raises():
    """A mesh over more than one device needs the world up; the client does
    not build a one-rank mesh in its place."""
    client = TPUClient(mesh_spec="dp=4", device="cpu")
    with pytest.raises(ValueError, match="connect needs a world of 4 ranks"):
        client.connect()
    one = TPUClient(mesh_spec="dp=-1", device="cpu")
    one.connect()
    assert one.mesh() is None and one.device_count() == 1
    with pytest.raises(Exception, match="shardings need a mesh"):
        one.compile("x", lambda t: t, torch.zeros(2), in_shardings=lambda m: None)
