"""Device-state telemetry on ``torch.cuda``: memory occupancy and the engine's
duty cycle (the port's counterpart of ``gofr_tpu/serving/device_telemetry.py``).

This poller samples, on its own daemon thread and never on the engine
thread:

- **the engine's card**, through the caching allocator's host-side
  counters: ``torch.cuda.memory_allocated(dev)`` as ``hbm_used_bytes`` (the
  bytes live tensors hold; the allocator's cached free blocks are not
  counted), ``torch.cuda.mem_get_info(dev)[1]`` as ``hbm_limit_bytes`` (the
  card's total memory) and their ratio ``hbm_util``, with ``platform``
  ``"gpu"``. Neither call synchronizes a stream, so polling cannot stall the
  engine's pipelined dispatches. An engine on the CPU reports no devices
  (the reference lists a backend without memory statistics by id and
  platform alone);
- **the engine's duty cycle** from the loop thread's busy counter
  (``ServingEngine.busy_seconds()``): the busy delta over the wall delta of
  the poll interval.

The sample is embedded in ``engine.health_check()`` (``details.device``);
:meth:`hbm_headroom` gives the free fraction. With a ``metrics`` object
(``set_gauge``; by default the engine's Manager, ``metrics=`` of the
engine) it exports the reference's gauges, registered by
``serving/metrics_catalog.py`` under the reference's names: ``app_tpu_hbm_bytes``
(labels ``device``, ``kind=used|limit``), ``app_tpu_hbm_used_bytes``,
``app_tpu_hbm_limit_bytes``, ``app_tpu_hbm_util`` and
``app_engine_duty_cycle``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

import torch

log = logging.getLogger(__name__)


class DeviceTelemetry:
    """Background device-state poller. ``start()`` spawns the daemon
    thread; ``sample()`` is also callable inline (tests, one-shot health
    probes)."""

    def __init__(self, engine: Any = None, *, metrics: Any = None,
                 interval_s: float = 5.0) -> None:
        self.engine = engine
        self._metrics = metrics if metrics is not None else getattr(engine, "_metrics", None)
        self.interval_s = max(0.1, float(interval_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._mu = threading.Lock()
        self._last: dict[str, Any] = {}
        # duty-cycle window: (busy_seconds, monotonic) at the last poll
        self._duty_mark: tuple[float, float] | None = None
        if engine is not None:
            engine.device_telemetry = self  # health_check embeds last_sample()

    # -- sampling --------------------------------------------------------------
    def _device_stats(self) -> list[dict[str, Any]]:
        dev = getattr(self.engine, "device", None)
        if dev is None or dev.type != "cuda":
            return []
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        used = int(torch.cuda.memory_allocated(index))
        limit = int(torch.cuda.mem_get_info(index)[1])
        return [{
            "id": index, "platform": "gpu",
            "hbm_used_bytes": used, "hbm_limit_bytes": limit,
            "hbm_util": round(used / limit, 4),
        }]

    def _duty_cycle(self, now: float) -> float | None:
        engine = self.engine
        if engine is None or not hasattr(engine, "busy_seconds"):
            return None
        busy = float(engine.busy_seconds())
        mark = self._duty_mark
        self._duty_mark = (busy, now)
        if mark is None:
            return None  # first poll: no window yet
        busy0, t0 = mark
        wall = now - t0
        if wall <= 0:
            return None
        return max(0.0, min(1.0, (busy - busy0) / wall))

    def sample(self) -> dict[str, Any]:
        """Take one sample, export the gauges, keep it for health."""
        now = time.monotonic()
        devices = self._device_stats()
        duty = self._duty_cycle(now)
        out: dict[str, Any] = {"devices": devices, "sampled_unix": time.time()}
        if duty is not None:
            out["engine_duty_cycle"] = round(duty, 4)
        hbm = self._headroom_of(devices)
        if hbm is not None:
            out["hbm_free_frac"] = round(hbm, 4)
        if self._metrics is not None:
            for dev in devices:
                label = str(dev["id"])
                self._metrics.set_gauge("app_tpu_hbm_bytes", dev["hbm_used_bytes"],
                                        device=label, kind="used")
                self._metrics.set_gauge("app_tpu_hbm_used_bytes", dev["hbm_used_bytes"],
                                        device=label)
                self._metrics.set_gauge("app_tpu_hbm_bytes", dev["hbm_limit_bytes"],
                                        device=label, kind="limit")
                self._metrics.set_gauge("app_tpu_hbm_limit_bytes", dev["hbm_limit_bytes"],
                                        device=label)
                self._metrics.set_gauge("app_tpu_hbm_util", dev["hbm_util"], device=label)
            if duty is not None:
                self._metrics.set_gauge("app_engine_duty_cycle", duty)
        with self._mu:
            self._last = out
        return out

    @staticmethod
    def _headroom_of(devices: list[dict[str, Any]]) -> float | None:
        """The tightest device's free-memory fraction."""
        fracs = [1.0 - dev["hbm_util"] for dev in devices]
        return min(fracs) if fracs else None

    # -- consumers -------------------------------------------------------------
    def last_sample(self) -> dict[str, Any]:
        with self._mu:
            return dict(self._last)

    def hbm_headroom(self) -> float | None:
        """Free-memory fraction of the tightest device, from the last poll
        (never samples inline)."""
        with self._mu:
            return self._last.get("hbm_free_frac")

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self.sample()  # prime: health sees data before the first interval
        self._thread = threading.Thread(target=self._loop, daemon=True, name="device-telemetry")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception as exc:
                log.debug("device telemetry poll failed: %s", exc)

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        self._thread = None
