"""The port's time-series family (``gofr_tpu_torch/datasource/timeseries``)
beside the JAX package's:

- writes, raw and windowed queries (every aggregation), tag filters,
  retention, ``delete_series``, ``measurements``, ``series_count``, the
  errors and health, on points made from a seed: equal results on both
  packages;
- ``TPUTelemetryRecorder`` over one fake device datasource writes equal rows
  on both packages;
- over the port's ``TPUClient(device="cpu")`` it writes one point per
  device, with the fields the client's CPU ``hbm_stats`` gives (zeros: the
  CPU has no caching allocator to read), tagged with the device's kind.
"""

import types

import numpy as np
import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import timeseries as rts
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import timeseries as tts

PKGS = {"ref": types.SimpleNamespace(ts=rts, config=RMapConfig),
        "port": types.SimpleNamespace(ts=tts, config=MapConfig)}
SIDES = sorted(PKGS)


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("raised", type(exc).__name__, str(exc))


def points(seed: int, n: int = 200) -> list[tuple]:
    """(measurement, tags, fields, timestamp): three routes on two hosts,
    out of order, some points without the ``bytes`` field."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fields = {"ms": float(rng.gamma(2.0, 10.0))}
        if rng.random() < 0.7:
            fields["bytes"] = int(rng.integers(0, 1 << 20))
        out.append(("latency", {"route": f"/r{int(rng.integers(0, 3))}",
                                "host": f"h{int(rng.integers(0, 2))}"},
                    fields, float(1000 + rng.uniform(0, 120))))
    return out


def queries(ts) -> list:
    out = [ts.measurements(), ts.series_count(), ts.series_count("latency"),
           ts.query("latency", "ms", start=1010.0, end=1030.5),
           ts.query("latency", "bytes", tags={"host": "h1"}),
           ts.query("latency", "ms", tags={"route": "/r2", "host": "h0"}, start=1050.0)]
    for agg in tts.AGGREGATIONS:
        for every in (1.0, 7.5, 60.0):
            out.append(ts.query("latency", "ms", aggregation=agg, every=every))
    out += [outcome(ts.query, "latency", "ms", aggregation="median", every=5.0),
            ts.query("absent", "ms"), ts.query("latency", "absent", every=1.0),
            outcome(ts.write_point, "m", {}, {}), ts.health_check()]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_writes_windows_and_aggregations_equal_the_reference(seed):
    got = {}
    for side in SIDES:
        ts = PKGS[side].ts.EmbeddedTimeSeries()
        ts.connect()
        for p in points(seed):
            ts.write_point(*p)
        got[side] = queries(ts)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 6 and len(got["port"][3]) > 0


def test_retention_delete_series_and_config_equal_the_reference():
    got = {}
    for side in SIDES:
        p = PKGS[side]
        ts = p.ts.EmbeddedTimeSeries.from_config(p.config({"TSDB_RETENTION_SECONDS": "30"},
                                                          use_env=False))
        steps = [ts.retention_seconds]
        for m, tags, fields, t in sorted(points(3, 80), key=lambda x: x[3]):
            ts.write_point(m, tags, fields, timestamp=t)
        steps += [ts.query("latency", "ms"), ts.delete_series("latency", tags={"host": "h0"}),
                  ts.series_count("latency"), ts.delete_series("ghost"),
                  ts.delete_series("latency"), ts.measurements(), ts.health_check()]
        ts.write_point("m", {"a": 1}, {"v": True}, timestamp=5)
        steps += [ts.query("m", "v", tags={"a": 1}),
                  p.ts.EmbeddedTimeSeries.from_config(p.config({}, use_env=False)).retention_seconds]
        ts.close()
        steps.append(ts.measurements())
        got[side] = steps
    assert got["port"] == got["ref"]
    assert min(r["time"] for r in got["port"][1]) >= max(p[3] for p in points(3, 80)) - 30


class FakeDevices:
    def hbm_stats(self):
        return {"devices": [
            {"device": "0", "kind": "NVIDIA H100 80GB HBM3", "bytes_in_use": 7.0,
             "bytes_limit": 16.0, "peak_bytes_in_use": 9.0},
            {"device": "1", "kind": "NVIDIA H100 80GB HBM3", "bytes_in_use": 3.0,
             "bytes_limit": 16.0},
        ]}


def test_recorder_over_a_fake_device_writes_the_references_rows(monkeypatch):
    got = {}
    for side in SIDES:
        mod = PKGS[side].ts
        clock = iter([100.0, 101.0, 102.0])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        ts = mod.EmbeddedTimeSeries()
        rec = mod.TPUTelemetryRecorder(FakeDevices(), ts, measurement="device")
        counts = [rec.sample(), rec.sample(ctx=object()), rec.sample()]
        got[side] = [counts] + [ts.query("device", f, aggregation="max", every=1.0)
                                for f in ("hbm_bytes_in_use", "hbm_bytes_limit", "hbm_peak_bytes")]
        got[side].append(ts.health_check()["details"])
    assert got["port"] == got["ref"]
    assert got["port"][0] == [2, 2, 2] and len(got["port"][1]) == 6


def test_recorder_over_the_ports_cpu_device_datasource():
    from gofr_tpu_torch.datasource.tpu import TPUClient

    client = TPUClient(device="cpu")
    client.connect()
    try:
        stats = client.hbm_stats()["devices"]
        ts = tts.EmbeddedTimeSeries()
        rec = tts.TPUTelemetryRecorder(client, ts)
        assert rec.sample() == len(stats) >= 1
        rows = {f: ts.query("tpu", f) for f in ("hbm_bytes_in_use", "hbm_bytes_limit",
                                                "hbm_peak_bytes")}
    finally:
        client.close()
    for dev, row in zip(stats, rows["hbm_bytes_in_use"]):
        assert row["tags"] == {"device": dev["device"], "kind": dev["kind"]}
        assert row["value"] == float(dev["bytes_in_use"]) == 0.0
    assert [r["value"] for r in rows["hbm_bytes_limit"]] == [float(d["bytes_limit"]) for d in stats]
    assert [r["value"] for r in rows["hbm_peak_bytes"]] == [
        float(d["peak_bytes_in_use"]) for d in stats]
