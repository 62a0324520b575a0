"""Time-series datasource — the InfluxDB/OpenTSDB-shaped contract
(container/datasources.go:790-830, :493-598) with an embedded backend.

Surface: ``write_point(measurement, tags, fields, ts)`` (the Influx line
protocol's data model), ``query`` with time range + tag filter +
windowed aggregation (mean/min/max/sum/count/last over ``every``
buckets — InfluxQL ``GROUP BY time(...)``), ``measurements``,
``delete_series``, retention trimming, health. Storage is per-series
columnar (parallel time/value arrays keyed by measurement + sorted tag
set), so range queries are a bisect, not a scan of unrelated series.

Dogfooded by :class:`TPUTelemetryRecorder`: the TPU
datasource's duty-cycle/HBM numbers are sampled into this store, so the
framework's own observability runs on its own time-series family.

The port's copy of ``gofr_tpu/datasource/timeseries/__init__.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any

AGGREGATIONS = ("mean", "min", "max", "sum", "count", "last")


class TimeSeriesError(Exception):
    status_code = 500


class _Series:
    """One (measurement, tagset) series: parallel sorted arrays."""

    __slots__ = ("tags", "times", "values")

    def __init__(self, tags: dict[str, str]) -> None:
        self.tags = tags
        self.times: list[float] = []
        self.values: list[dict[str, float]] = []

    def insert(self, ts: float, fields: dict[str, float]) -> None:
        i = bisect.bisect_right(self.times, ts)
        self.times.insert(i, ts)
        self.values.insert(i, fields)

    def window(self, start: float, end: float) -> tuple[list[float], list[dict]]:
        lo = bisect.bisect_left(self.times, start)
        hi = bisect.bisect_right(self.times, end)
        return self.times[lo:hi], self.values[lo:hi]


def _aggregate(agg: str, values: list[float]) -> float:
    if not values:
        return 0.0
    if agg == "mean":
        return sum(values) / len(values)
    if agg == "min":
        return min(values)
    if agg == "max":
        return max(values)
    if agg == "sum":
        return sum(values)
    if agg == "count":
        return float(len(values))
    if agg == "last":
        return values[-1]
    raise TimeSeriesError(f"unknown aggregation {agg!r} (want one of {AGGREGATIONS})")


class EmbeddedTimeSeries:
    def __init__(self, retention_seconds: float | None = None) -> None:
        self.retention_seconds = retention_seconds
        # measurement → {frozenset(tag items) → _Series}
        self._series: dict[str, dict[frozenset, _Series]] = {}
        self._lock = threading.Lock()
        self._points_written = 0
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "EmbeddedTimeSeries":
        retention = config.get("TSDB_RETENTION_SECONDS")
        return cls(retention_seconds=float(retention) if retention else None)

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        if self._logger:
            self._logger.debug("embedded time-series store ready")

    # -- writes ------------------------------------------------------------
    def write_point(
        self,
        measurement: str,
        tags: dict[str, str] | None = None,
        fields: dict[str, float] | None = None,
        timestamp: float | None = None,
    ) -> None:
        if not fields:
            raise TimeSeriesError("a point needs at least one field")
        ts = time.time() if timestamp is None else float(timestamp)
        tags = {str(k): str(v) for k, v in (tags or {}).items()}
        key = frozenset(tags.items())
        clean = {str(k): float(v) for k, v in fields.items()}
        with self._lock:
            series = self._series.setdefault(measurement, {})
            s = series.get(key)
            if s is None:
                s = series[key] = _Series(tags)
            s.insert(ts, clean)
            self._points_written += 1
            if self.retention_seconds is not None:
                self._trim_locked(measurement, ts - self.retention_seconds)

    def _trim_locked(self, measurement: str, cutoff: float) -> None:
        for s in self._series.get(measurement, {}).values():
            lo = bisect.bisect_left(s.times, cutoff)
            if lo:
                del s.times[:lo]
                del s.values[:lo]

    # -- queries -----------------------------------------------------------
    def query(
        self,
        measurement: str,
        field: str,
        start: float | None = None,
        end: float | None = None,
        tags: dict[str, str] | None = None,
        aggregation: str = "mean",
        every: float | None = None,
    ) -> list[dict[str, Any]]:
        """Points (or windowed aggregates when ``every`` is set) for one
        field across all series matching the tag filter. Rows:
        ``{"time", "value", "tags"}`` sorted by time."""
        start = float("-inf") if start is None else start
        end = float("inf") if end is None else end
        out: list[dict[str, Any]] = []
        with self._lock:
            for s in self._series.get(measurement, {}).values():
                if tags and any(s.tags.get(k) != str(v) for k, v in tags.items()):
                    continue
                times, values = s.window(start, end)
                pts = [
                    (t, v[field]) for t, v in zip(times, values) if field in v
                ]
                if not pts:
                    continue
                if every is None:
                    out.extend(
                        {"time": t, "value": v, "tags": dict(s.tags)} for t, v in pts
                    )
                else:
                    buckets: dict[float, list[float]] = {}
                    for t, v in pts:
                        buckets.setdefault(t - (t % every), []).append(v)
                    out.extend(
                        {
                            "time": bt,
                            "value": _aggregate(aggregation, bucket),
                            "tags": dict(s.tags),
                        }
                        for bt, bucket in buckets.items()
                    )
        out.sort(key=lambda r: (r["time"], sorted(r["tags"].items())))
        return out

    def measurements(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def series_count(self, measurement: str | None = None) -> int:
        with self._lock:
            if measurement is not None:
                return len(self._series.get(measurement, {}))
            return sum(len(v) for v in self._series.values())

    def delete_series(self, measurement: str, tags: dict[str, str] | None = None) -> int:
        with self._lock:
            series = self._series.get(measurement)
            if series is None:
                return 0
            if tags is None:
                n = len(series)
                del self._series[measurement]
                return n
            doomed = [
                k for k, s in series.items()
                if all(s.tags.get(tk) == str(tv) for tk, tv in tags.items())
            ]
            for k in doomed:
                del series[k]
            return len(doomed)

    # -- lifecycle / health ------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        with self._lock:
            return {
                "status": "UP",
                "details": {
                    "backend": "embedded-timeseries",
                    "measurements": len(self._series),
                    "series": sum(len(v) for v in self._series.values()),
                    "points_written": self._points_written,
                    "retention_seconds": self.retention_seconds,
                },
            }

    def close(self) -> None:
        with self._lock:
            self._series.clear()


class TPUTelemetryRecorder:
    """Dogfood hook: sample the TPU datasource's HBM
    and duty-cycle state into the time-series store. Drive it from a cron
    job (``app.add_cron_job("* * * * * *", "tpu-telemetry", rec.sample)``)
    or call ``sample()`` from any loop."""

    def __init__(self, tpu: Any, store: EmbeddedTimeSeries,
                 measurement: str = "tpu") -> None:
        self.tpu = tpu
        self.store = store
        self.measurement = measurement

    def sample(self, ctx: Any = None) -> int:
        """Record one point per device; returns points written."""
        stats = self.tpu.hbm_stats()
        now = time.time()
        n = 0
        for dev in stats.get("devices", []):
            self.store.write_point(
                self.measurement,
                tags={"device": str(dev.get("device")), "kind": dev.get("kind", "")},
                fields={
                    "hbm_bytes_in_use": float(dev.get("bytes_in_use", 0)),
                    "hbm_bytes_limit": float(dev.get("bytes_limit", 0)),
                    "hbm_peak_bytes": float(dev.get("peak_bytes_in_use", 0)),
                },
                timestamp=now,
            )
            n += 1
        return n
