"""TPUClient on one CUDA card (port of ``gofr_tpu/datasource/tpu/client.py``).

The client drives the NVIDIA card; it keeps the reference's names, so
``ctx.tpu.execute(...)`` in a handler ports unchanged.

- ``connect`` finds the card (``device``: the card unless the caller
  passes ``"cpu"``; without one it raises, as every entry point does).
- ``compile(name, fn, *example_args)`` is the counterpart of
  ``jax.jit(fn).lower(*args).compile()``. On the card it allocates the
  static inputs (copies of the example tensors, or zeros for a
  ``(shape, dtype)`` spec), runs ``fn`` once on a side stream (the
  warm-up, which also builds the hand-written kernels: ``nvcc`` cannot
  run inside a capture), then captures ``fn`` on that stream into a
  ``torch.cuda.CUDAGraph``. A capture that fails is a :class:`TPUError`
  at ``compile``; nothing falls back to eager. Each graph has a memory
  pool of its own, and whatever a captured launch reads or writes must
  come from it: a kernel wrapper's scratch cache may hand its buffers
  back later, so under a capture the wrappers allocate theirs anew
  (``ops/paged_attention.py``). The meta keeps
  ``compile_seconds``, ``flops`` (``FlopCounterMode`` over the warm-up:
  it counts PyTorch's operators and does not see the hand-written
  kernels), ``bytes_accessed`` (None), and ``captured_launches``: each
  kernel wrapper's launch-counter delta during the capture. A wrapper
  counts its launch once, at capture; a replay launches the same kernels
  again without counting, so a replay's launches are ``captured_launches``
  and the executable's total is that times ``replays``.
- ``execute(name, *args)`` checks every argument's shape, dtype and
  device against the static inputs (a mismatch is a :class:`TPUError`
  before anything runs, since ``copy_`` would broadcast silently; health
  shows it as ``last_error``, but a caller's error does not feed the
  breaker), copies the arguments in,
  replays the graph and returns fresh outputs (clones: a static output is
  overwritten by the next replay, and the reference returns new arrays
  every call). It runs in the ``tpu.execute {name}`` span and feeds the
  duty-cycle window and the ``app_http_service_response`` histogram
  (``type="tpu_execute"``). On the CPU (``device="cpu"``, the tests)
  ``compile`` keeps ``fn`` and ``execute`` calls it eagerly: the explicit
  CPU path, not a fallback.
- Generators: torch's capture registers the card's default generator
  itself, so its draws advance on every replay. Any other generator
  ``fn`` draws from must be passed as ``generators=``; its draws would
  otherwise repeat on every replay.
- ``hbm_stats`` reads the caching allocator (``serving/device_telemetry.py``
  ``card_memory``): bytes in use, their peak and the card's total.

Sick-device breaker (the reference's, on one card): consecutive failures
of an executable past ``TPU_BREAKER_THRESHOLD`` probe the device through a
persistent :class:`_DeviceProber` thread with a deadline. If it answers,
the failure is not the device's (a typed "all devices probe healthy"
error). If it does not, the device is excluded: there is no mesh to
shrink onto, so every ``execute`` raises the reference's "all devices
excluded" :class:`TPUError` and health is DEGRADED naming device 0. After
``TPU_BREAKER_COOLDOWN_S`` the half-open restore probes the device again
and restores it when it answers (a failed probe restarts the cooldown:
an optimistic restore of the only device would fail ``threshold`` more
requests before re-tripping). A sticky CUDA error (an illegal address, a
device-side assert) ends the process's CUDA context: every later probe
fails, and only a new process heals it.

Refused, not ignored (ROADMAP Queue C): a ``TPU_MESH`` that resolves to
more than one device (Queue A item 14: the mesh exists in ``parallel/``, the
client over it and the sick-chip failover do not yet),
``TPU_PJRT_PLUGIN`` (a libtpu plugin) and ``TPU_COMPILE_CACHE_DIR`` (a
CUDA graph cannot be persisted). The native PJRT probe is not ported
(Queue A item 7): ``health_check`` keeps the reference's keys without
``native_pjrt``, and ``mesh`` is None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any

import torch

from gofr_tpu_torch import tree as tree_util
from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

# the kernel wrappers whose launch counters a capture records
KERNEL_WRAPPERS = (flash_attention, paged_decode_attention, paged_decode_attention_q)


class TPUError(Exception):
    status_code = 503

    def log_level(self):  # late import to avoid a cycle
        from gofr_tpu_torch.logging.level import Level

        return Level.ERROR


class DeviceBreaker:
    """Breaker state (circuit_breaker.go's Closed/Open model re-targeted
    at devices): consecutive failures are counted PER EXECUTABLE (a
    generic execute error cannot name the faulty device), and when an
    executable trips the threshold the client probes each device and only
    proven-bad ones enter the exclusion registry."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0) -> None:
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._failures: dict[str, int] = {}  # executable name → consecutive
        self.excluded: dict[int, float] = {}  # device id → exclusion time

    def record_failure(self, name: str) -> bool:
        """Count a failure of ``name``; True when it trips the threshold
        (the count resets so the state after the trip starts clean)."""
        self._failures[name] = self._failures.get(name, 0) + 1
        if self._failures[name] >= self.threshold:
            self._failures[name] = 0
            return True
        return False

    def record_success(self, name: str) -> None:
        self._failures.pop(name, None)

    def exclude(self, device_ids: list[int]) -> None:
        now = time.monotonic()
        for did in device_ids:
            self.excluded.setdefault(did, now)

    def cooldown_elapsed(self) -> bool:
        if not self.excluded:
            return False
        return time.monotonic() - max(self.excluded.values()) >= self.cooldown_s

    def reset(self) -> None:
        self._failures.clear()
        self.excluded.clear()


class _DeviceProber:
    """One LONG-LIVED probe thread per device. A probe of a wedged device
    hangs; the hang wedges only this prober: later sweeps see it busy,
    report the device failed at once and spawn nothing. If the device
    ever answers, the prober finishes its iteration and is reusable."""

    def __init__(self, device_id: int) -> None:
        self.device_id = device_id
        self._req = threading.Event()
        self._done = threading.Event()
        self._stop = False
        self._ok = False
        self._busy = False
        self._job: tuple[Any, Any] | None = None  # (probe_fn, device)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def request(self, probe_fn: Any, device: Any) -> bool:
        """Begin a probe; False when the previous probe is still wedged
        (count the device failed, don't pile up another thread)."""
        with self._lock:
            if self._busy:
                return False
            self._busy = True
            self._job = (probe_fn, device)
        self._done.clear()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=f"tpu-prober-{self.device_id}",
            )
            self._thread.start()
        self._req.set()
        return True

    def _loop(self) -> None:
        while not self._stop:
            # gofrlint: disable=cancel-unreachable,unbounded-wire-call -- _req doubles as the stop wake: stop() sets _stop, then _req, so this wait IS the stop gate
            self._req.wait()
            self._req.clear()
            if self._stop:
                return
            with self._lock:
                probe_fn, device = self._job
            try:
                ok = probe_fn(device)
            except Exception:
                ok = False
            with self._lock:
                # _done is set before _busy clears, under the lock: else a
                # new request() could clear _done and then take THIS
                # probe's set as its own
                self._ok = ok
                self._done.set()
                self._busy = False

    def wait(self, deadline: float) -> bool:
        """True iff the probe completed before ``deadline`` AND the device
        answered correctly. A timeout leaves the prober busy (wedged)."""
        if not self._done.wait(max(0.0, deadline - time.monotonic())):
            return False
        return self._ok

    def stop(self) -> None:
        self._stop = True
        self._req.set()


@dataclasses.dataclass(frozen=True)
class _Device:
    id: int
    device: torch.device
    kind: str
    platform: str  # "gpu" | "cpu"


class _Executable:
    """A captured graph with its static inputs and outputs (on the card),
    or the function itself (on the CPU)."""

    def __init__(self, fn: Any, static_inputs: list, static_argnums: tuple,
                 graph: Any = None, static_out: Any = None) -> None:
        self.fn = fn
        self.static_inputs = static_inputs  # per argument: a tensor, or the static value
        self.static_argnums = static_argnums
        self.graph = graph
        self.static_out = static_out
        self.lock = threading.Lock()  # one replay at a time: the buffers are shared

    def check(self, name: str, args: tuple) -> None:
        if len(args) != len(self.static_inputs):
            raise TPUError(
                f"execute {name}: {len(args)} arguments, compiled with {len(self.static_inputs)}"
            )
        for i, (arg, want) in enumerate(zip(args, self.static_inputs)):
            if i in self.static_argnums:
                if arg != want:
                    raise TPUError(
                        f"execute {name}: static argument {i} is {arg!r}, compiled with {want!r}"
                    )
                continue
            if not isinstance(arg, torch.Tensor):
                raise TPUError(f"execute {name}: argument {i} is a {type(arg).__name__}, not a tensor")
            if arg.shape != want.shape or arg.dtype != want.dtype or arg.device != want.device:
                raise TPUError(
                    f"execute {name}: argument {i} is {arg.dtype}{list(arg.shape)} on {arg.device}, "
                    f"compiled for {want.dtype}{list(want.shape)} on {want.device}"
                )

    def run(self, args: tuple) -> Any:
        if self.graph is None:
            return self.fn(*args)
        with self.lock:
            for i, (arg, static) in enumerate(zip(args, self.static_inputs)):
                if i not in self.static_argnums:
                    static.copy_(arg)
            self.graph.replay()
            return tree_util.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                      self.static_out)


def _mesh_size(spec: Any) -> int:
    """Devices a ``TPU_MESH`` spec (``"dp=2,tp=4"``; -1 fills) asks for on
    one card: the product of its sizes, -1 taken as 1."""
    size = 1
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        axis, sep, value = part.partition("=")
        try:
            n = int(value)
        except ValueError:
            raise ValueError(f"TPU_MESH={spec!r}: {part!r} is not axis=size") from None
        if not sep or not axis.strip() or n == 0 or n < -1:
            raise ValueError(f"TPU_MESH={spec!r}: {part!r} is not axis=size")
        size *= 1 if n == -1 else n
    return size


def _launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


class TPUClient:
    def __init__(
        self,
        mesh_spec: str | None = None,
        platform: str | None = None,
        compile_cache_dir: str | None = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if mesh_spec is not None and _mesh_size(mesh_spec) > 1:
            raise ValueError(
                f"TPU_MESH={mesh_spec!r} spans more than one device: the mesh needs the "
                "client over a mesh (ROADMAP Queue A item 14); the client drives one card"
            )
        if platform:
            raise ValueError(
                f"TPU_PJRT_PLUGIN={platform!r}: a PJRT plugin has no counterpart on the CUDA card"
            )
        if compile_cache_dir:
            raise ValueError(
                f"TPU_COMPILE_CACHE_DIR={compile_cache_dir!r}: a CUDA graph cannot be persisted"
            )
        self.mesh_spec = mesh_spec
        self.platform = platform
        self.compile_cache_dir = compile_cache_dir
        self._device_arg = device
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None
        self._all_devices: list[_Device] = []  # as discovered at connect
        self._executables: dict[str, _Executable] = {}
        self._exec_meta: dict[str, dict] = {}
        self._breaker = DeviceBreaker(breaker_threshold, breaker_cooldown_s)
        self._lock = threading.Lock()
        # exclusion and restore are atomic w.r.t. each other; _epoch names
        # the device-set generation, so a failure dispatched before the
        # last change skips the breaker
        self._failover_lock = threading.RLock()
        self._epoch = 0
        self._probers: dict[int, _DeviceProber] = {}
        self._stream: Any = None  # the warm-up and capture stream (card)
        self._busy_ns = 0
        self._window_start = time.monotonic()
        self._last_error: str | None = None

    @classmethod
    def from_config(cls, config: Any, *, device: str | torch.device | None = None) -> "TPUClient":
        return cls(
            mesh_spec=config.get("TPU_MESH") or None,
            platform=config.get("TPU_PJRT_PLUGIN") or None,
            compile_cache_dir=config.get("TPU_COMPILE_CACHE_DIR") or None,
            breaker_threshold=int(config.get_or_default("TPU_BREAKER_THRESHOLD", "3")),
            breaker_cooldown_s=float(config.get_or_default("TPU_BREAKER_COOLDOWN_S", "30")),
            device=device,
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        dev = resolve_device(self._device_arg)
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            dev = torch.device("cuda", index)
            found = _Device(index, dev, torch.cuda.get_device_name(index), "gpu")
        else:
            found = _Device(0, dev, "cpu", "cpu")
        with self._failover_lock:
            self._all_devices = [found]
        if self._logger:
            self._logger.info(f"tpu datasource connected: 1 device(s) ({found.kind}), mesh=None")
        self._publish_hbm_gauges()

    @property
    def _devices(self) -> list[_Device]:
        """The devices not excluded by the breaker."""
        return [d for d in self._all_devices if d.id not in self._breaker.excluded]

    # -- TPU contract ----------------------------------------------------------
    def device_count(self) -> int:
        return len(self._devices)

    def mesh(self) -> Any:
        return None  # one card: no mesh until the parallel plane is ported

    def compile(
        self,
        name: str,
        fn: Any,
        *example_args: Any,
        donate_argnums: Any = (),
        static_argnums: Any = (),
        generators: Any = (),
    ) -> _Executable:
        """Build the executable of ``fn`` for ``example_args`` (tensors, or
        ``(shape, dtype)`` specs; the positions in ``static_argnums`` are
        plain values baked in) and cache it under ``name``. A donated
        argument needs nothing here: execute copies every argument into
        the graph's own buffers."""
        if not self._all_devices:
            raise TPUError(f"compilation of {name} failed: not connected")
        dev = self._all_devices[0].device
        static_argnums = tuple(static_argnums)
        with self._span(f"tpu.compile {name}"):
            start = time.perf_counter()
            try:
                inputs = [arg if i in static_argnums else _static_input(arg, dev)
                          for i, arg in enumerate(example_args)]
                exe, flops, captured = self._build(fn, inputs, static_argnums, generators, dev)
            except Exception as exc:
                self._last_error = f"compile {name}: {exc}"
                raise TPUError(f"compilation of {name} failed: {exc}") from exc
            elapsed = time.perf_counter() - start
        with self._lock:
            self._executables[name] = exe
            self._exec_meta[name] = {
                "compile_seconds": elapsed,
                "flops": flops,
                "bytes_accessed": None,
                "graph": exe.graph is not None,
                "captured_launches": captured,
                "replays": 0,
                "donate_argnums": tuple(donate_argnums),
            }
        if self._logger:
            self._logger.info(f"compiled executable {name} in {elapsed:.2f}s")
        return exe

    def _build(self, fn: Any, inputs: list, static_argnums: tuple, generators: Any,
               dev: torch.device) -> tuple[_Executable, float | None, dict]:
        from torch.utils.flop_counter import FlopCounterMode

        if dev.type == "cpu":
            with FlopCounterMode(display=False) as counter:
                fn(*inputs)
            return _Executable(fn, inputs, static_argnums), float(counter.get_total_flops()), {}
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):  # the warm-up: builds kernels, fills caches
            with FlopCounterMode(display=False) as counter:
                fn(*inputs)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = _launch_counts()
        # thread_local: a CUDA call another thread makes meanwhile (a
        # telemetry poll) is not an error of this capture
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            static_out = fn(*inputs)
        after = _launch_counts()
        torch.cuda.current_stream(dev).wait_stream(stream)
        captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        exe = _Executable(fn, inputs, static_argnums, graph, static_out)
        return exe, float(counter.get_total_flops()), captured

    def get_executable(self, name: str) -> _Executable | None:
        with self._lock:
            return self._executables.get(name)

    def execute(self, name: str, *args: Any, block: bool = False) -> Any:
        """Run a cached executable into fresh outputs. Asynchronous on the
        card unless ``block=True`` (which waits for the card). Failures
        feed the breaker."""
        self._maybe_restore()
        epoch = self._epoch
        if not self._devices:
            raise TPUError("all devices excluded by the sick-chip breaker")
        exe = self.get_executable(name)
        if exe is None:
            raise TPUError(f"executable {name} not compiled")
        try:
            exe.check(name, args)
        except TPUError as exc:
            self._last_error = str(exc)
            raise
        start = time.perf_counter_ns()
        with self._span(f"tpu.execute {name}"):
            try:
                out = exe.run(args)
                if block and exe.graph is not None:
                    torch.cuda.synchronize(self._all_devices[0].device)
            except Exception as exc:
                self._last_error = f"execute {name}: {exc}"
                return self._on_execute_failure(name, args, block, exc, epoch)
        self._breaker.record_success(name)
        self._last_error = None
        with self._lock:
            meta = self._exec_meta.get(name)
            if meta is not None:
                meta["replays"] += 1
        self._observe_execution(name, time.perf_counter_ns() - start)
        return out

    def _probe_device(self, device: _Device) -> bool:
        """One tiny op on the device: does it still answer?"""
        x = torch.ones(8, dtype=torch.float32, device=device.device)
        return bool((x + 1).cpu()[0] == 2.0)

    def _probe_devices_safely(self, devices: list, timeout_s: float = 5.0) -> list[int]:
        """Probe every device through its persistent prober under one
        shared deadline (a wedged device HANGS rather than raises). At
        most one thread per device for the client's lifetime: a device
        whose previous probe never returned is reported failed without
        spawning anything. Returns the ids that failed to answer."""
        failed: list[int] = []
        pending: list[_DeviceProber] = []
        for d in devices:
            prober = self._probers.get(d.id)
            if prober is None:
                prober = _DeviceProber(d.id)
                self._probers[d.id] = prober
            if prober.request(self._probe_device, d):
                pending.append(prober)
            else:
                failed.append(d.id)  # still wedged from a previous sweep
        deadline = time.monotonic() + timeout_s
        for prober in pending:
            if not prober.wait(deadline):
                failed.append(prober.device_id)
        return failed

    def _on_execute_failure(self, name: str, args: tuple, block: bool, exc: Exception,
                            epoch: int | None = None) -> Any:
        """Breaker bookkeeping. Below the threshold the caller gets the
        typed 503. The failure that trips it probes the device: healthy is
        a typed "all devices probe healthy" error (bad input, OOM, a bug);
        failed excludes it, and with one card nothing is left to retry on.
        A failure dispatched before the device set last changed skips the
        breaker and retries once on the current set, as the reference's
        stale-epoch path does."""
        with self._failover_lock:
            if epoch is not None and epoch != self._epoch:
                exe = self.get_executable(name) if self._devices else None
                if exe is None:
                    raise TPUError(f"execution of {name} failed: {exc}") from exc
            else:
                if not self._breaker.record_failure(name):
                    raise TPUError(f"execution of {name} failed: {exc}") from exc
                newly = self._probe_devices_safely(self._devices)
                if not newly:
                    raise TPUError(
                        f"execution of {name} failed (all devices probe healthy): {exc}"
                    ) from exc
                self._breaker.exclude(newly)
                self._epoch += 1
                if self._logger:
                    self._logger.error(
                        f"sick-chip breaker tripped on device(s) {newly} after repeated "
                        f"failures of {name}; no healthy device is left"
                    )
                if self._metrics:
                    for did in newly:
                        self._metrics.increment_counter(
                            "app_tpu_devices_excluded_total", device=str(did)
                        )
                raise TPUError("all devices excluded by the sick-chip breaker") from exc
        retry_start = time.perf_counter_ns()
        with self._span(f"tpu.execute {name} (failover)"):
            try:
                out = exe.run(args)
                if block and exe.graph is not None:
                    torch.cuda.synchronize(self._all_devices[0].device)
            except Exception as rexc:
                self._last_error = f"execute {name} (failover): {rexc}"
                raise TPUError(f"execution of {name} failed even after failover: {rexc}") from rexc
        self._breaker.record_success(name)
        self._last_error = None
        self._observe_execution(name, time.perf_counter_ns() - retry_start)
        return out

    def _maybe_restore(self, timeout_s: float = 5.0) -> None:
        """Half-open probe: after the cooldown, probe the excluded devices
        and restore those that answer; a device that does not answer
        starts a new cooldown. Double-checked under the failover lock."""
        if not (self._breaker.excluded and self._breaker.cooldown_elapsed()):
            return
        with self._failover_lock:
            if not (self._breaker.excluded and self._breaker.cooldown_elapsed()):
                return
            excluded = sorted(self._breaker.excluded)
            probe = [d for d in self._all_devices if d.id in self._breaker.excluded]
            still = self._probe_devices_safely(probe, timeout_s)
            if still:
                self._breaker.excluded.clear()
                self._breaker.exclude(still)  # a fresh cooldown
                if self._logger:
                    self._logger.warn(f"sick-chip breaker cooldown elapsed; device(s) {still} "
                                      "still do not answer")
                return
            self._breaker.reset()
            self._epoch += 1
            if self._logger:
                self._logger.info(
                    f"sick-chip breaker cooldown elapsed; device(s) {excluded} answer again"
                )

    def _observe_execution(self, name: str, busy_ns: int) -> None:
        with self._lock:
            self._busy_ns += busy_ns
            window = time.monotonic() - self._window_start
            if window >= 10.0:
                duty = min(1.0, self._busy_ns / 1e9 / window)
                if self._metrics:
                    self._metrics.set_gauge("app_tpu_duty_cycle", duty)
                self._busy_ns = 0
                self._window_start = time.monotonic()
        if self._metrics:
            self._metrics.record_histogram(
                "app_http_service_response", busy_ns / 1e9,
                type="tpu_execute", executable=name,
            )

    # -- memory / health -------------------------------------------------------
    def hbm_stats(self) -> dict[str, Any]:
        from gofr_tpu_torch.serving.device_telemetry import card_memory

        per_device = []
        for d in self._devices:
            mem = card_memory(d.id) if d.platform == "gpu" else {"used": 0, "limit": 0, "peak": 0}
            per_device.append({
                "device": str(d.id), "kind": d.kind, "bytes_in_use": mem["used"],
                "bytes_limit": mem["limit"], "peak_bytes_in_use": mem["peak"],
            })
        return {"devices": per_device}

    def _publish_hbm_gauges(self) -> None:
        if not self._metrics:
            return
        for dev in self.hbm_stats()["devices"]:
            self._metrics.set_gauge("app_tpu_hbm_used_bytes", dev["bytes_in_use"], device=dev["device"])
            self._metrics.set_gauge("app_tpu_hbm_limit_bytes", dev["bytes_limit"], device=dev["device"])

    def health_check(self) -> dict[str, Any]:
        if not self._all_devices:
            return {"status": "DOWN", "details": {"error": "not connected"}}
        self._publish_hbm_gauges()
        with self._lock:
            executables = sorted(self._executables)
        details: dict[str, Any] = {
            "platform": self._all_devices[0].platform,
            "device_count": len(self._devices),
            "mesh": None,
            "executables": executables,
            "hbm": self.hbm_stats()["devices"],
        }
        if self._breaker.excluded:
            # DEGRADED must NAME the excluded device
            details["excluded_devices"] = sorted(self._breaker.excluded)
            details["devices_discovered"] = len(self._all_devices)
            if self._last_error:
                details["last_error"] = self._last_error
            return {"status": "DEGRADED", "details": details}
        if self._last_error:
            details["last_error"] = self._last_error
            return {"status": "DEGRADED", "details": details}
        return {"status": "UP", "details": details}

    def close(self) -> None:
        with self._lock:
            self._executables.clear()
        for prober in self._probers.values():
            prober.stop()
        self._probers.clear()

    # -- helpers ---------------------------------------------------------------
    def _span(self, name: str):
        if self._tracer is not None:
            return self._tracer.start_span(name, kind="client")
        return contextlib.nullcontext()


def _static_input(arg: Any, dev: torch.device) -> torch.Tensor:
    """The executable's own buffer for one argument: a copy of an example
    tensor, or zeros for a ``(shape, dtype)`` spec."""
    if isinstance(arg, torch.Tensor):
        return arg.detach().to(dev, copy=True)
    if (isinstance(arg, (tuple, list)) and len(arg) == 2
            and isinstance(arg[1], torch.dtype)):
        return torch.zeros(tuple(arg[0]), dtype=arg[1], device=dev)
    raise TypeError(
        f"an example argument must be a tensor or a (shape, dtype) spec, not {arg!r}"
    )


def new_tpu(config: Any, *, device: str | torch.device | None = None) -> TPUClient:
    return TPUClient.from_config(config, device=device)
