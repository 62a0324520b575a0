"""The port's device datasource (``gofr_tpu_torch/datasource/tpu``) beside
the JAX package's ``TPUClient``, on the CPU (``device="cpu"``: ``compile``
keeps the function and ``execute`` calls it eagerly): the cases of
``tests/test_tpu_datasource.py``, the single-device cases of
``tests/test_sick_chip.py`` (a trip whose probe finds the device healthy;
a failing probe that excludes the only device, after which every execute
raises "all devices excluded" and health is DEGRADED naming it; the
cooldown's restore; probe threads bounded with a wedged device; the
``DeviceBreaker`` unit; the stale-epoch path), the refused config keys,
``ctx.tpu`` in a handler over HTTP on each package's ``App``, the typed
503 for an unknown executable and for a wrong-shape argument on both
sides, spans and series. The card's capture is in
``test_torch_datasource_cuda.py``."""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gofr_tpu  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.datasource.tpu import TPUClient as JTPUClient  # noqa: E402
from gofr_tpu.datasource.tpu.client import DeviceBreaker as JDeviceBreaker  # noqa: E402
from gofr_tpu.datasource.tpu.client import TPUError as JTPUError  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig  # noqa: E402
from gofr_tpu_torch.datasource.tpu import TPUClient, TPUError, new_tpu  # noqa: E402
from gofr_tpu_torch.datasource.tpu.client import DeviceBreaker  # noqa: E402
from gofr_tpu_torch.metrics import new_metrics_manager  # noqa: E402
from gofr_tpu_torch.serving.metrics_catalog import register_serving_metrics  # noqa: E402
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app  # noqa: E402
from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor, Tracer  # noqa: E402


@pytest.fixture
def tpu():
    client = TPUClient(device="cpu")
    client.use_metrics(register_serving_metrics(new_metrics_manager()))
    client.connect()
    yield client
    client.close()


# -- tests/test_tpu_datasource.py ---------------------------------------------
def test_compile_and_execute(tpu):
    tpu.compile("double", lambda x: x * 2, torch.zeros(4))
    out = tpu.execute("double", torch.ones(4), block=True)
    assert torch.equal(out, torch.full((4,), 2.0))
    meta = tpu._exec_meta["double"]
    assert meta["graph"] is False and meta["bytes_accessed"] is None
    assert meta["compile_seconds"] >= 0 and meta["replays"] == 1
    assert tpu.device_count() == 1 and tpu.mesh() is None


def test_compile_takes_shape_specs_and_static_args(tpu):
    tpu.compile("mm", lambda a, b, k: (a @ b) * k, ((3, 4), torch.float32),
                torch.ones(4, 2), 3.0, static_argnums=(2,))
    a = torch.arange(12.0).reshape(3, 4)
    out = tpu.execute("mm", a, torch.ones(4, 2), 3.0)
    assert torch.equal(out, (a @ torch.ones(4, 2)) * 3)
    assert tpu._exec_meta["mm"]["flops"] == 2 * 3 * 4 * 2  # FlopCounterMode's matmul count
    with pytest.raises(TPUError, match="static argument 2"):
        tpu.execute("mm", a, torch.ones(4, 2), 4.0)


def test_execute_unknown_raises_typed_503_on_both_sides():
    ref = JTPUClient(mesh_spec="dp=8")
    ref.connect()
    port = TPUClient(device="cpu")
    port.connect()
    got = {}
    for side, client, err, arg in (("ref", ref, JTPUError, jnp.zeros(1)),
                                   ("port", port, TPUError, torch.zeros(1))):
        with pytest.raises(err) as exc:
            client.execute("missing", arg)
        got[side] = (exc.value.status_code, str(exc.value))
    assert got["port"] == got["ref"] == (503, "executable missing not compiled")
    port.close()


@pytest.mark.parametrize("bad", [torch.ones(5), torch.ones(4, dtype=torch.float64),
                                 torch.ones(2, 2)], ids=["shape", "dtype", "rank"])
def test_a_mismatched_argument_is_a_typed_error_before_anything_runs(tpu, bad):
    calls = []
    tpu.compile("inc", lambda x: calls.append(1) or x + 1, torch.zeros(4))
    calls.clear()
    with pytest.raises(TPUError, match="argument 0") as exc:
        tpu.execute("inc", bad)
    assert exc.value.status_code == 503 and calls == []
    assert tpu.health_check()["status"] == "DEGRADED"
    assert tpu._breaker._failures == {}  # a caller's error does not feed the breaker
    tpu.execute("inc", torch.zeros(4))
    assert tpu.health_check()["status"] == "UP"


def test_health_reports_devices_and_executables(tpu):
    tpu.compile("inc", lambda x: x + 1, torch.zeros(2))
    health = tpu.health_check()
    assert health["status"] == "UP"
    details = health["details"]
    assert details["device_count"] == 1 and details["mesh"] is None
    assert details["platform"] == "cpu" and "inc" in details["executables"]
    assert "native_pjrt" not in details
    assert details["hbm"] == [{"device": "0", "kind": "cpu", "bytes_in_use": 0,
                               "bytes_limit": 0, "peak_bytes_in_use": 0}]
    ref = JTPUClient(mesh_spec="dp=8")
    ref.connect()
    ref.compile("inc", lambda x: x + 1, jnp.zeros((2,)))
    want = ref.health_check()
    assert set(details) == set(want["details"]) - {"native_pjrt"}
    assert set(details["hbm"][0]) == set(want["details"]["hbm"][0])


def test_from_config():
    client = TPUClient.from_config(MapConfig({"TPU_MESH": "dp=1", "TPU_BREAKER_THRESHOLD": "5",
                                              "TPU_BREAKER_COOLDOWN_S": "2.5"}, use_env=False),
                                   device="cpu")
    client.connect()
    assert client.device_count() == 1 and client.mesh() is None
    assert (client._breaker.threshold, client._breaker.cooldown_s) == (5, 2.5)
    assert new_tpu(MapConfig({"TPU_MESH": "dp=-1"}, use_env=False), device="cpu") is not None


@pytest.mark.parametrize("values,match", [
    ({"TPU_MESH": "dp=2,tp=4"}, "more than one device"),
    ({"TPU_MESH": "tp=2"}, "more than one device"),
    ({"TPU_MESH": "dp"}, "axis=size"),
    ({"TPU_PJRT_PLUGIN": "/opt/libtpu.so"}, "PJRT plugin"),
    ({"TPU_COMPILE_CACHE_DIR": "/tmp/cache"}, "cannot be persisted"),
])
def test_refused_config_keys(values, match):
    with pytest.raises(ValueError, match=match):
        new_tpu(MapConfig(values, use_env=False), device="cpu")


def test_unconnected_health_down():
    got = (TPUClient().health_check(), JTPUClient().health_check())
    assert got[0] == got[1] == {"status": "DOWN", "details": {"error": "not connected"}}


def test_connect_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPUClient().connect()


# -- tests/test_sick_chip.py, one device ---------------------------------------
def _flaky(client, name: str, failures: int) -> dict:
    """Make ``name`` fail its next ``failures`` runs, on either package."""
    state = {"remaining": failures, "calls": 0}
    if isinstance(client, TPUClient):
        exe = client._executables[name]
        real = exe.run

        def run(args):
            state["calls"] += 1
            if state["remaining"] > 0:
                state["remaining"] -= 1
                raise RuntimeError("injected device failure (wedged chip)")
            return real(args)

        exe.run = run
    else:
        real = client._executables[name]

        def call(*args):
            state["calls"] += 1
            if state["remaining"] > 0:
                state["remaining"] -= 1
                raise RuntimeError("injected device failure (wedged chip)")
            return real(*args)

        client._executables[name] = call
    return state


def _one_device_ref(threshold: int, cooldown: float) -> JTPUClient:
    client = JTPUClient(mesh_spec="dp=-1", breaker_threshold=threshold,
                        breaker_cooldown_s=cooldown)
    client.connect()
    client._all_devices = client._all_devices[:1]
    client._rebuild_mesh()
    return client


def _one_device_port(threshold: int, cooldown: float) -> TPUClient:
    client = TPUClient(breaker_threshold=threshold, breaker_cooldown_s=cooldown, device="cpu")
    client.use_metrics(register_serving_metrics(new_metrics_manager()))
    client.connect()
    return client


def test_trip_with_a_healthy_probe_is_a_typed_error_on_both_sides():
    got = {}
    for side in ("ref", "port"):
        if side == "ref":
            client, err, arg = _one_device_ref(3, 30.0), JTPUError, jnp.ones((4,), jnp.float32)
            client.compile("inc", lambda x: x + 1, jnp.zeros((4,), jnp.float32))
        else:
            client, err, arg = _one_device_port(3, 30.0), TPUError, torch.ones(4)
            client.compile("inc", lambda x: x + 1, torch.zeros(4))
        client._probe_device = lambda d: True
        _flaky(client, "inc", 10)
        messages = []
        for _ in range(3):
            with pytest.raises(err) as exc:
                client.execute("inc", arg)
            messages.append((exc.value.status_code, str(exc.value)))
        health = client.health_check()
        got[side] = (messages, client.device_count(), health["status"],
                     "excluded_devices" in health["details"], health["details"]["last_error"])
        client.close()
    assert got["port"] == got["ref"]
    assert "all devices probe healthy" in got["port"][0][2][1]


def test_a_failing_probe_excludes_the_only_device():
    """The trip's probe fails: the device is excluded and the tripping call
    raises the reference's "all devices excluded" error (as the reference
    does on one device). The port then refuses every execute with it, a
    healthy executable too, and health is DEGRADED naming device 0."""
    ref = _one_device_ref(3, 60.0)
    ref.compile("inc", lambda x: x + 1, jnp.zeros((2,), jnp.float32))
    ref._probe_device = lambda d: False
    _flaky(ref, "inc", 99)
    port = _one_device_port(3, 60.0)
    port.compile("inc", lambda x: x + 1, torch.zeros(2))
    port.compile("ok", lambda x: x * 3, torch.zeros(2))
    port._probe_device = lambda d: False
    state = _flaky(port, "inc", 99)
    got = {}
    for side, client, err, arg in (("ref", ref, JTPUError, jnp.ones((2,), jnp.float32)),
                                   ("port", port, TPUError, torch.ones(2))):
        for _ in range(2):
            with pytest.raises(err, match="execution of inc failed"):
                client.execute("inc", arg)
        with pytest.raises(err) as exc:
            client.execute("inc", arg)
        got[side] = str(exc.value)
    assert got["port"] == got["ref"] == "all devices excluded by the sick-chip breaker"
    calls = state["calls"]
    for name in ("inc", "ok"):
        with pytest.raises(TPUError, match="all devices excluded") as exc:
            port.execute(name, torch.ones(2))
        assert exc.value.status_code == 503
    assert state["calls"] == calls  # nothing ran
    health = port.health_check()
    assert health["status"] == "DEGRADED"
    assert health["details"]["excluded_devices"] == [0]
    assert health["details"]["devices_discovered"] == 1 and health["details"]["device_count"] == 0
    text = port._metrics.expose_prometheus()
    assert 'app_tpu_devices_excluded_total{device="0"} 1' in text
    port.close()


def test_cooldown_probe_restores_the_device():
    """After the cooldown the next execute probes the excluded device: a
    device that still fails stays excluded for a fresh cooldown; one that
    answers is restored, and health is UP."""
    client = _one_device_port(1, 0.3)
    client.compile("inc", lambda x: x + 1, torch.zeros(2))
    client._probe_device = lambda d: False
    _flaky(client, "inc", 1)
    with pytest.raises(TPUError, match="all devices excluded"):
        client.execute("inc", torch.ones(2))
    time.sleep(0.35)
    with pytest.raises(TPUError, match="all devices excluded"):  # probed again: still sick
        client.execute("inc", torch.ones(2))
    assert client.health_check()["status"] == "DEGRADED"
    client._probe_device = lambda d: True  # the device recovered
    time.sleep(0.35)
    out = client.execute("inc", torch.ones(2), block=True)
    assert torch.equal(out, torch.full((2,), 2.0))
    assert client.device_count() == 1 and client.health_check()["status"] == "UP"
    client.close()


def test_probe_threads_bounded_with_wedged_device():
    client = _one_device_port(1, 999)
    hang = threading.Event()  # never set until the end: device 0's probe blocks

    def probe(d):
        hang.wait()
        return True

    client._probe_device = probe
    baseline = threading.active_count()
    for _ in range(5):
        assert client._probe_devices_safely(client._devices, timeout_s=0.2) == [0]
    assert threading.active_count() - baseline <= len(client._devices)
    hang.set()
    client.close()


@pytest.mark.parametrize("cls", [DeviceBreaker, JDeviceBreaker], ids=["port", "ref"])
def test_device_breaker_unit(cls):
    b = cls(threshold=2, cooldown_s=0.05)
    assert b.record_failure("f") is False
    assert b.record_failure("f") is True  # trips, count resets
    assert b.record_failure("f") is False
    b.record_success("g")  # unknown name: no-op
    b.record_failure("g")
    b.record_success("g")
    assert b.record_failure("g") is False  # success reset the count
    b.exclude([3])
    assert 3 in b.excluded
    assert not b.cooldown_elapsed()
    time.sleep(0.06)
    assert b.cooldown_elapsed()
    b.reset()
    assert not b.excluded


def test_stale_epoch_failure_skips_breaker():
    """A failure dispatched before the device set last changed (here: an
    exclusion and its restore) does not feed the breaker or probe: it
    retries on the current set."""
    client = _one_device_port(1, 0.1)
    probed = []

    def probe(d):
        probed.append(d.id)
        return len(probed) > 1  # fails the trip's probe, answers the restore's

    client._probe_device = probe
    client.compile("inc", lambda x: x + 1, torch.zeros(4))
    _flaky(client, "inc", 1)
    with pytest.raises(TPUError, match="all devices excluded"):
        client.execute("inc", torch.ones(4))
    time.sleep(0.15)
    client.execute("inc", torch.ones(4))  # the restore
    assert client._epoch == 2 and probed == [0, 0]
    out = client._on_execute_failure("inc", (torch.ones(4),), True,
                                     RuntimeError("stale failure"), epoch=0)
    assert torch.equal(out, torch.full((4,), 2.0))
    assert probed == [0, 0] and client._breaker._failures == {}
    client.close()


# -- observability ---------------------------------------------------------------
def test_spans_and_series():
    exporter = InMemoryExporter()
    tracer = Tracer("t", SimpleSpanProcessor(exporter))
    metrics = register_serving_metrics(new_metrics_manager())
    client = TPUClient(device="cpu")
    client.use_tracer(tracer)
    client.use_metrics(metrics)
    client.connect()
    client.compile("inc", lambda x: x + 1, torch.zeros(2))
    client.execute("inc", torch.ones(2))
    names = [s.name for s in exporter.spans]
    assert names == ["tpu.compile inc", "tpu.execute inc"]
    assert all(s.kind == "client" for s in exporter.spans)
    text = metrics.expose_prometheus()
    assert 'app_http_service_response_count{executable="inc",type="tpu_execute"} 1' in text
    assert "\napp_tpu_duty_cycle " not in text  # the 10 s window has not closed
    client._window_start -= 10.0
    client.execute("inc", torch.ones(2))
    assert "\napp_tpu_duty_cycle " in metrics.expose_prometheus()
    client.close()


# -- ctx.tpu over HTTP, beside the reference -------------------------------------
def _conf(side: str) -> dict:
    return {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
            "HTTP_HOST": "127.0.0.1", "APP_NAME": f"tpu-{side}", "LOG_LEVEL": "FATAL"}


@pytest.fixture(scope="module")
def served():
    ref = gofr_tpu.App(RMapConfig(_conf("ref"), use_env=False))
    ref.add_tpu(JTPUClient(mesh_spec="dp=-1"))
    ref.container.tpu.compile("double", lambda x: x * 2, jnp.zeros((4,), jnp.float32))

    def ref_handler(ctx):
        x = jnp.asarray(ctx.bind(dict)["x"], jnp.float32)
        return {"y": np.asarray(ctx.tpu.execute(ctx.path_param("name"), x, block=True)).tolist()}

    ref.post("/run/{name}", ref_handler)
    port = TApp(MapConfig(_conf("port"), use_env=False))
    port.add_tpu(TPUClient(device="cpu"))
    port.container.tpu.compile("double", lambda x: x * 2, torch.zeros(4))

    def port_handler(ctx):
        x = torch.tensor(ctx.bind(dict)["x"], dtype=torch.float32)
        return {"y": ctx.tpu.execute(ctx.path_param("name"), x, block=True).tolist()}

    port.post("/run/{name}", port_handler)
    apps = {"ref": ref, "port": port}
    threads = {side: start_app(app) for side, app in apps.items()}
    yield apps
    for side, app in apps.items():
        stop_app(app, threads[side])


def _call(app, path: str, payload=None, method="POST"):
    body = json.dumps(payload).encode() if payload is not None else None
    status, _, data = fetch(f"http://127.0.0.1:{app.http_port}{path}", method, body,
                            {"Content-Type": "application/json"}, timeout=60)
    return status, json.loads(data)


def test_ctx_tpu_executes_in_a_handler_on_both_sides(served):
    got = {side: _call(app, "/run/double", {"x": [1, 2, 3, 4.5]}) for side, app in served.items()}
    assert got["port"] == got["ref"] == (201, {"data": {"y": [2.0, 4.0, 6.0, 9.0]}})


@pytest.mark.parametrize("path,payload", [("/run/missing", {"x": [1, 2, 3, 4]}),
                                          ("/run/double", {"x": [1, 2, 3]})],
                         ids=["unknown-executable", "wrong-shape"])
def test_typed_503_through_the_handler_on_both_sides(served, path, payload):
    got = {side: _call(app, path, payload) for side, app in served.items()}
    assert got["port"][0] == got["ref"][0] == 503
    if path == "/run/missing":
        assert got["port"] == got["ref"]
    # the next success clears the error on both sides
    for app in served.values():
        assert _call(app, "/run/double", {"x": [0, 0, 0, 0]})[0] == 201


def test_health_aggregates_the_tpu_datasource(served):
    got = {}
    for side, app in served.items():
        status, body = _call(app, "/.well-known/health", method="GET")
        tpu = body["data"]["details"]["tpu"]
        got[side] = (status, tpu["status"], sorted(tpu["details"]["executables"]),
                     set(tpu["details"]["hbm"][0]))
    assert got["port"] == got["ref"]
    assert got["port"][1] == "UP"
    assert served["port"].container.datasource_pairs()[0] == ("tpu", served["port"].container.tpu)
