"""The metrics port: /metrics + diagnostics + device profiler (a copy of
``gofr_tpu/metrics/server.py`` with ``torch.profiler`` in place of
``jax.profiler``).

Reference parity: pkg/gofr/metrics/handler.go:13-52 + metrics_server.go —
Prometheus exposition on :2121/metrics, plus the pprof-style debug surface
(/debug/pprof/* in the reference; here /debug/threads, /debug/gc,
/debug/vars — Python's runtime diagnostics) and health/alive.

The device profiler mounted beside pprof: POST
/debug/profiler/start?dir=… starts a ``torch.profiler.profile`` over the
CPU and, where a card is visible, CUDA activities (kernels, copies);
POST /debug/profiler/stop ends it, writes its Chrome trace into ``dir``
and reports the file. A second start while one runs is a 409, a stop with
none running a 409, any other method a 405, as in the reference.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import sys
import threading
import time
import traceback
from typing import Any

from gofr_tpu_torch.http.responder import WireResponse


class MetricsHandler:
    def __init__(self, container: Any) -> None:
        self.container = container
        self._profile_dir: str | None = None
        self._profiler: Any = None
        self._profile_lock = threading.Lock()

    async def __call__(self, req: Any) -> WireResponse:
        path = req.path
        if path == "/metrics":
            body = self.container.metrics_manager.expose_prometheus().encode()
            return WireResponse(headers={"Content-Type": "text/plain; version=0.0.4"}, body=body)
        if path == "/.well-known/alive":
            return _json({"status": "UP"})
        if path == "/.well-known/health":
            return _json(self.container.health())
        if path == "/debug/threads" or path == "/debug/pprof/goroutine":
            lines = []
            frames = sys._current_frames()
            for t in threading.enumerate():
                lines.append(f"--- {t.name} (daemon={t.daemon}) ---")
                frame = frames.get(t.ident or -1)
                if frame:
                    lines.extend(l.rstrip() for l in traceback.format_stack(frame))
            return WireResponse(headers={"Content-Type": "text/plain"}, body="\n".join(lines).encode())
        if path == "/debug/gc" or path == "/debug/pprof/heap":
            stats = {"gc_stats": gc.get_stats(), "objects": len(gc.get_objects())}
            return _json(stats)
        if path in ("/debug/profiler/start", "/debug/profiler/stop") and \
                getattr(req, "method", "POST").upper() != "POST":
            return _json({"error": "method not allowed; use POST"}, status=405)
        if path == "/debug/profiler/start":
            directory = req.param("dir") or "/tmp/gofr-tpu-profile"
            with self._profile_lock:
                if self._profile_dir is not None:
                    return _json(
                        {"error": "profiler already running",
                         "dir": self._profile_dir},
                        status=409,
                    )
                try:
                    self._profiler = _start_torch_profiler()
                except Exception as exc:
                    return _json({"error": str(exc)}, status=500)
                self._profile_dir = directory
            return _json({"profiling": True, "dir": directory})
        if path == "/debug/profiler/stop":
            with self._profile_lock:
                if self._profile_dir is None:
                    return _json({"error": "profiler not running"}, status=409)
                directory, self._profile_dir = self._profile_dir, None
                prof, self._profiler = self._profiler, None
            try:
                # stopped on the thread that started it; the trace file is
                # written off the event loop (it can take seconds)
                prof.stop()
                trace = await asyncio.get_running_loop().run_in_executor(
                    None, _export_trace, prof, directory)
            except Exception as exc:
                return _json({"error": str(exc), "dir": directory}, status=500)
            return _json({"profiling": False, "dir": directory, "trace": trace})
        if path == "/debug/vars":
            return _json(
                {
                    "threads": threading.active_count(),
                    "app": self.container.app_name,
                    "version": self.container.app_version,
                }
            )
        return WireResponse(status=404, body=b"404 not found")


def _json(obj: Any, status: int = 200) -> WireResponse:
    return WireResponse(
        status=status,
        headers={"Content-Type": "application/json"},
        body=json.dumps(obj, default=str).encode(),
    )


def _start_torch_profiler() -> Any:
    """A started ``torch.profiler.profile`` over the CPU and, with a card
    visible, CUDA activities. The profiler records the operators of the
    thread that starts it only, unless told to record every thread: the
    engine's loop, its detok worker and the handlers' threads are the ones
    worth seeing, so every thread is recorded where this PyTorch can."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):  # a PyTorch without the option
        config = None
    prof = torch.profiler.profile(activities=activities, experimental_config=config)
    prof.start()
    return prof


def _export_trace(prof: Any, directory: str) -> str:
    """Write a stopped profile's Chrome trace into ``directory``; returns
    the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
