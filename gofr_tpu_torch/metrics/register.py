"""The metrics Manager: typed instruments with label sets (port of
``gofr_tpu/metrics/register.py``, the same code: the exposition is
byte-identical to the reference's for the same operations).

Reference parity: pkg/gofr/metrics/register.go:16-277 — counters, up-down
counters, histograms with explicit buckets, and settable gauges (the
float64Gauge workaround :42-48 becomes a first-class Gauge here). Labels are
passed as alternating key/value pairs or kwargs, like the reference's
variadic ``labels ...string``.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterable

from gofr_tpu_torch.metrics.store import MetricsError, Store

DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.0075, 0.01, 0.025, 0.05, 0.075,
    0.1, 0.25, 0.5, 0.75, 1, 2.5, 5, 7.5, 10, 30, 60,
)

LabelArgs = Iterable[str]


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _parse_labels(args: tuple, kwargs: dict[str, Any]) -> dict[str, str]:
    if args and len(args) % 2 != 0:
        raise MetricsError("labels must be alternating key/value pairs")
    labels = {str(args[i]): str(args[i + 1]) for i in range(0, len(args), 2)}
    labels.update({k: str(v) for k, v in kwargs.items()})
    return labels


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, description: str) -> None:
        self.name = name
        self.description = description
        self._lock = threading.Lock()

    def expose(self) -> list[str]:  # Prometheus text lines
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, description: str) -> None:
        super().__init__(name, description)
        self._series: dict[tuple, float] = {}

    def add(self, value: float, labels: dict[str, str]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._series.get(_label_key(labels or {}), 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.description}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, val in sorted(self._series.items()):
                lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")
        return lines


class UpDownCounter(Counter):
    kind = "gauge"  # Prometheus has no updown type; exposed as gauge

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.description}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, val in sorted(self._series.items()):
                lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")
        return lines


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, description: str) -> None:
        super().__init__(name, description)
        self._series: dict[tuple, float] = {}
        self._callbacks: list[Any] = []

    def set(self, value: float, labels: dict[str, str]) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def delete(self, labels: dict[str, str]) -> None:
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def value(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._series.get(_label_key(labels or {}), math.nan)

    def observe_with(self, callback: Any) -> None:
        """Register a callable returning {labels_tuple: value} evaluated at
        scrape time — used for runtime gauges (goroutine-count analogue)."""
        with self._lock:
            self._callbacks.append(callback)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.description}", f"# TYPE {self.name} gauge"]
        with self._lock:
            series = dict(self._series)
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                for labels, value in cb().items():
                    series[_label_key(dict(labels))] = value
            except Exception:
                continue
        for key, val in sorted(series.items()):
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")
        return lines


class Histogram(_Instrument):
    kind = "histogram"

    # raw observations retained per series for exact percentiles — the
    # shared instrument replaces ad-hoc private sample rings (the
    # router's old `_ttfts`), so its percentile must be as precise as
    # the rings it replaced, not a bucket upper bound
    RECENT_WINDOW = 512

    def __init__(self, name: str, description: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, description)
        self.buckets = tuple(sorted(buckets))
        self._series: dict[tuple, list] = {}  # key -> [bucket_counts, sum, count]
        self._recent: dict[tuple, Any] = {}   # key -> deque of last-N raw values

    def record(self, value: float, labels: dict[str, str]) -> None:
        key = _label_key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                import collections

                state = [[0] * len(self.buckets), 0.0, 0]
                self._series[key] = state
                self._recent[key] = collections.deque(maxlen=self.RECENT_WINDOW)
            counts, _, _ = state
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            state[1] += value
            state[2] += 1
            self._recent[key].append(value)

    def snapshot(self, labels: dict[str, str] | None = None) -> tuple[float, int]:
        with self._lock:
            state = self._series.get(_label_key(labels or {}))
            return (state[1], state[2]) if state else (0.0, 0)

    def percentile(self, q: float, labels: dict[str, str] | None = None) -> float:
        """Exact percentile over the last ``RECENT_WINDOW`` observations
        of the series (rank-based, like the sample rings this replaced).
        NaN when the series has no observations."""
        with self._lock:
            recent = self._recent.get(_label_key(labels or {}))
            if not recent:
                return math.nan
            ordered = sorted(recent)
        n = len(ordered)
        return ordered[min(int(q * n), n - 1)]

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.description}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, (counts, total_sum, count) in sorted(self._series.items()):
                for i, ub in enumerate(self.buckets):
                    bucket_labels = key + (("le", _fmt_value(ub)),)
                    lines.append(
                        f"{self.name}_bucket{_fmt_labels(tuple(sorted(bucket_labels)))} {counts[i]}"
                    )
                inf_labels = key + (("le", "+Inf"),)
                lines.append(f"{self.name}_bucket{_fmt_labels(tuple(sorted(inf_labels)))} {count}")
                lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total_sum)}")
                lines.append(f"{self.name}_count{_fmt_labels(key)} {count}")
        return lines


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    parts = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + parts + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Manager:
    """The metrics facade handed to handlers via the Container
    (register.go:16-26). All methods are safe to call concurrently."""

    def __init__(self, logger: Any = None) -> None:
        self._store = Store()
        self._logger = logger

    # -- registration --------------------------------------------------------
    def new_counter(self, name: str, description: str = "") -> None:
        self._register(Counter(name, description))

    def new_updown_counter(self, name: str, description: str = "") -> None:
        self._register(UpDownCounter(name, description))

    def new_gauge(self, name: str, description: str = "") -> None:
        self._register(Gauge(name, description))

    def new_histogram(self, name: str, description: str = "", buckets: tuple[float, ...] | list[float] = DEFAULT_BUCKETS) -> None:
        self._register(Histogram(name, description, tuple(buckets)))

    def _register(self, inst: _Instrument) -> None:
        try:
            self._store.register(inst.name, inst)
        except MetricsError as exc:
            if self._logger:
                self._logger.error(str(exc))
            else:
                raise

    # -- recording (never raises on unknown metric; logs like the reference) --
    def increment_counter(self, name: str, *labels: str, **label_kw: Any) -> None:
        self._record(name, (Counter, UpDownCounter), "add", 1.0, labels, label_kw)

    def delta_updown_counter(self, name: str, value: float, *labels: str, **label_kw: Any) -> None:
        self._record(name, (UpDownCounter,), "add", value, labels, label_kw)

    def record_histogram(self, name: str, value: float, *labels: str, **label_kw: Any) -> None:
        self._record(name, (Histogram,), "record", value, labels, label_kw)

    def set_gauge(self, name: str, value: float, *labels: str, **label_kw: Any) -> None:
        self._record(name, (Gauge,), "set", value, labels, label_kw)

    def delete_gauge(self, name: str, *labels: str, **label_kw: Any) -> None:
        inst = self._store.try_get(name)
        if isinstance(inst, Gauge):
            inst.delete(_parse_labels(labels, label_kw))

    def _record(self, name: str, kinds: tuple, method: str, value: float, labels: tuple, label_kw: dict) -> None:
        inst = self._store.try_get(name)
        if inst is None or not isinstance(inst, kinds):
            if self._logger:
                self._logger.error(f"metric {name} is not registered or wrong type")
            return
        try:
            parsed = _parse_labels(labels, label_kw)
        except MetricsError as exc:
            if self._logger:
                self._logger.error(str(exc))
            return
        if method == "add":
            inst.add(value, parsed)
        elif method == "record":
            inst.record(value, parsed)
        else:
            inst.set(value, parsed)

    # -- introspection -------------------------------------------------------
    def get(self, name: str) -> Any:
        return self._store.try_get(name)

    def expose_prometheus(self) -> str:
        lines: list[str] = []
        for inst in sorted(self._store.all(), key=lambda i: i.name):
            lines.extend(inst.expose())
        return "\n".join(lines) + "\n"


def new_metrics_manager(logger: Any = None) -> Manager:
    return Manager(logger)
