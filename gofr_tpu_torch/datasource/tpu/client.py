"""TPUClient on the CUDA card and over a mesh of ranks (port of
``gofr_tpu/datasource/tpu/client.py``).

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

Over a mesh (``TPU_MESH`` across more than one device): the reference is
one controller driving every chip; the port is SPMD, one process a rank
of a ``torch.distributed`` world that the caller has already joined
(``parallel.world.init_parallel``, or ``run_spmd``). A device id is a
rank; on the one card every rank sits on ``cuda:0`` over gloo (NCCL
refuses two ranks on one card). Every rank builds its own client with the
same arguments and calls ``connect``, ``compile`` and ``execute`` with the
same arguments in the same order: each call may hold collectives over the
world. ``connect`` raises when no world of the spec's size is up; it
builds no one-rank mesh in its place.

- The mesh is ``parallel.mesh``'s :class:`Mesh` over the ranks the breaker
  has not excluded (``join_mesh``; the spec refitted by
  :func:`_shrink_spec`, the reference's policy). A rank outside it (an
  excluded one) stays alive and keeps the caller's view: it holds no
  shard, runs nothing, and still returns every call's result.
- ``compile(name, fn, *examples, in_shardings=, out_shardings=)`` takes
  global examples and the port's :class:`NamedSharding` (one for a
  one-argument ``fn``, else a tuple with one per argument, None for a
  replicated one), or a callable ``mesh -> shardings`` that stays
  rebuildable across a failover; concrete shardings are bound to the mesh
  they name, and such an executable is refused after a shrink, as the
  reference refuses it. Each rank captures ``fn`` over its local shard.
  ``fn`` must be the per-shard computation: a collective inside it is
  REFUSED at ``compile`` with a :class:`TPUError` (a gloo collective runs
  on the host and cannot be captured into a CUDA graph; the CPU refuses
  it too, so the two devices do not differ). The meta says so
  (``collectives: "refused"``, ``captured``), and health shows a refused
  compile as ``last_error``.
- ``execute`` takes the global arguments, runs each rank's shard, agrees
  the outcome over the world (one all-reduce: a rank's failure is every
  rank's failure, with the failing rank's message), and assembles the
  global result outside the capture: ``out_shardings`` gathers each split
  dimension over its axes (``parallel.collectives.all_gather``, the
  shared-memory ring on one host); without them each rank's output is the
  result. A rank outside the mesh gets the result by a broadcast over the
  world.
- The breaker: a trip probes each rank's own device, and the results are
  agreed over the whole world (an all-reduce) before any rank excludes
  anything; every rank then excludes the same ranks, joins the new
  mesh's groups and recompiles the tripping executable from its recipe
  (callable shardings), and the tripping call is retried on the
  survivors. The stale-epoch skip and the bounded probe threads hold per
  rank. After the cooldown (agreed over the world) the full mesh is
  restored optimistically, as the reference restores it: a still-sick
  device re-trips. The mesh of each device set is built once and kept, so
  a restore brings back the mesh object the first executables were bound
  to.
- Health: ``mesh`` is ``{axis: size}``, DEGRADED names the excluded ranks;
  ``hbm`` lists this rank's own device (another rank's memory is another
  process's).

Refused, not ignored (ROADMAP Queue C): ``TPU_PJRT_PLUGIN`` (a libtpu
plugin) and ``TPU_COMPILE_CACHE_DIR`` (a CUDA graph cannot be persisted).
The native PJRT probe is not ported (Queue A item 7): ``health_check``
keeps the reference's keys without ``native_pjrt``; on one card ``mesh``
is None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any

import torch
import torch.distributed as dist

from gofr_tpu_torch import tree as tree_util
from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q
from gofr_tpu_torch.parallel import collectives
from gofr_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, join_mesh
from gofr_tpu_torch.parallel.sharding import NamedSharding, local_index

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
    id: int  # the card's index on one card; the rank over a mesh
    device: torch.device | None  # None: another rank's device, in another process
    kind: str
    platform: str  # "gpu" | "cpu"


class _Executable:
    """A captured graph with its static inputs and outputs (on the card),
    or the function itself (on the CPU). Over a mesh it runs this rank's
    shard: ``placement`` holds the per-argument shardings, the output
    shardings and the mesh, ``signature`` the global (shape, dtype) of each
    argument, and ``local`` is False on a rank outside the mesh (it holds
    nothing and runs nothing)."""

    def __init__(self, fn: Any, static_inputs: list, static_argnums: tuple,
                 graph: Any = None, static_out: Any = None) -> None:
        self.fn = fn
        self.static_inputs = static_inputs  # per argument: a tensor, or the static value
        self.static_argnums = static_argnums
        self.graph = graph
        self.static_out = static_out
        self.lock = threading.Lock()  # one replay at a time: the buffers are shared
        self.placement: tuple[list, Any, Any] | None = None  # (in shardings, out, mesh)
        self.signature: list | None = None  # global (shape, dtype) or the static value
        self.local = True

    def check(self, name: str, args: tuple, dev: torch.device | None = None) -> None:
        want_all = self.signature if self.signature is not None else self.static_inputs
        if len(args) != len(want_all):
            raise TPUError(
                f"execute {name}: {len(args)} arguments, compiled with {len(want_all)}"
            )
        for i, (arg, want) in enumerate(zip(args, want_all)):
            if i in self.static_argnums:
                if arg != want:
                    raise TPUError(
                        f"execute {name}: static argument {i} is {arg!r}, compiled with {want!r}"
                    )
                continue
            if not isinstance(arg, torch.Tensor):
                raise TPUError(f"execute {name}: argument {i} is a {type(arg).__name__}, not a tensor")
            if self.signature is not None:
                shape, dtype = want
                want_dev = dev
            else:
                shape, dtype, want_dev = want.shape, want.dtype, want.device
            if arg.shape != shape or arg.dtype != dtype or (want_dev is not None
                                                            and arg.device != want_dev):
                raise TPUError(
                    f"execute {name}: argument {i} is {arg.dtype}{list(arg.shape)} on {arg.device}, "
                    f"compiled for {dtype}{list(shape)} on {want_dev}"
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

    def shard_args(self, args: tuple) -> tuple:
        """This rank's shard of each global argument."""
        if self.placement is None:
            return args
        in_list, _, mesh = self.placement
        return tuple(
            a if s is None or i in self.static_argnums
            else a[local_index(tuple(a.shape), s.spec, mesh)]
            for i, (a, s) in enumerate(zip(args, in_list))
        )


def _mesh_size(spec: Any) -> int:
    """Devices a ``TPU_MESH`` spec (``"dp=2,tp=4"`` or a ``MeshSpec``; -1
    fills) asks for without a world: the product of its sizes, -1 taken
    as 1."""
    if isinstance(spec, MeshSpec):
        return math.prod(max(n, 1) for n in spec.sizes())
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


def _shrink_spec(spec: MeshSpec | None, n_healthy: int) -> MeshSpec:
    """Refit a mesh spec onto fewer devices after exclusion (the
    reference's policy). Model-parallel axes (tp/sp/ep/pp/fsdp) keep their
    size when they still fit (shrinking them changes each device's memory
    layout) and the dp (replica) axis absorbs the loss; when the model
    axes themselves no longer fit, halve the innermost one until they do
    (power-of-two steps keep shapes divisible)."""
    if spec is None:
        return MeshSpec(dp=max(1, n_healthy))
    sizes = dict(zip(AXIS_ORDER, spec.sizes()))
    model_axes = [a for a in AXIS_ORDER if a != "dp"]
    other = math.prod(sizes[a] for a in model_axes)
    while other > n_healthy:
        for a in ("tp", "sp", "ep", "pp", "fsdp"):  # innermost first
            if sizes[a] > 1:
                sizes[a] = sizes[a] // 2 if sizes[a] % 2 == 0 else 1
                break
        else:
            break
        other = math.prod(sizes[a] for a in model_axes)
    sizes["dp"] = max(1, n_healthy // max(other, 1))
    return MeshSpec(**sizes)


def _launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def _per_argument(shardings: Any, n: int, what: str) -> list:
    """One sharding (or None) a position: a :class:`NamedSharding` for a
    one-position call, or a tuple/list with one per position."""
    if shardings is None:
        return [None] * n
    if isinstance(shardings, NamedSharding):
        shardings = (shardings,)
    if not isinstance(shardings, (tuple, list)) or len(shardings) != n or not all(
            s is None or isinstance(s, NamedSharding) for s in shardings):
        raise TPUError(
            f"{what} must be a parallel.sharding.NamedSharding for one position or a tuple "
            f"with one (or None) for each of the {n}, not {shardings!r}"
        )
    return list(shardings)


class TPUClient:
    def __init__(
        self,
        mesh_spec: str | MeshSpec | None = None,
        platform: str | None = None,
        compile_cache_dir: str | None = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        if isinstance(mesh_spec, str):
            _mesh_size(mesh_spec)  # the grammar, checked before any connect
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
        self._recipes: dict[str, dict] = {}  # name → how to recompile (over a mesh)
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
        # over a mesh (a world of ranks is up at connect)
        self._rank: int | None = None  # None: one card
        self._own: torch.device | None = None  # this process's device
        self._mesh: Any = None  # None on one card, and on a rank outside the mesh
        self._mesh_devices: list[_Device] = []
        self._mesh_sizes: dict[str, int] = {}
        self._meshes: dict[tuple, Any] = {}  # (sizes, ranks) → Mesh, built once

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
        self._own = dev
        if dist.is_initialized():
            self._connect_world(found)
            return
        if self.mesh_spec is not None and _mesh_size(self.mesh_spec) > 1:
            raise ValueError(
                f"TPU_MESH={self.mesh_spec!r} spans more than one device: connect needs a world "
                f"of {_mesh_size(self.mesh_spec)} ranks up (parallel.world.init_parallel or "
                "run_spmd), and none is"
            )
        with self._failover_lock:
            self._all_devices = [found]
        if self._logger:
            self._logger.info(f"tpu datasource connected: 1 device(s) ({found.kind}), mesh=None")
        self._publish_hbm_gauges()

    def _connect_world(self, found: _Device) -> None:
        """Every rank: one device a rank, the mesh over all of them."""
        world, rank = dist.get_world_size(), dist.get_rank()
        spec = self._spec()
        try:
            spec = (spec or MeshSpec(dp=world)).resolve(world)
        except ValueError as exc:
            raise ValueError(f"TPU_MESH={self.mesh_spec!r} does not fit the world of {world} "
                             f"rank(s): {exc}") from None
        kinds: list = [None] * world
        dist.all_gather_object(kinds, (found.kind, found.platform))
        with self._failover_lock:
            self._rank = rank
            self._all_devices = [
                _Device(r, found.device if r == rank else None, kind, plat)
                for r, (kind, plat) in enumerate(kinds)
            ]
            self._rebuild_mesh()
        if self._logger:
            self._logger.info(
                f"tpu datasource connected: {world} device(s) ({found.kind}), "
                f"mesh={self._mesh_shape()}, rank {rank}"
            )
        self._publish_hbm_gauges()

    def _spec(self) -> MeshSpec | None:
        return MeshSpec.parse(self.mesh_spec) if isinstance(self.mesh_spec, str) else self.mesh_spec

    def _rebuild_mesh(self) -> None:
        """(Re)build the mesh over the devices the breaker has not excluded
        (a collective: every rank calls it at the same point). When the
        device set changes, the executables compiled for the old one are
        dropped (their recipes recompile on next use); a rebuild onto the
        same set keeps them."""
        with self._failover_lock:
            healthy = [d for d in self._all_devices if d.id not in self._breaker.excluded]
            if not healthy:
                raise TPUError("all devices excluded by the sick-chip breaker")
            spec = self._spec()
            n_all = len(self._all_devices)
            if len(healthy) < n_all:
                spec = _shrink_spec(spec.resolve(n_all) if spec else None, len(healthy))
                new = healthy[: spec.total()]
            else:
                spec = (spec or MeshSpec(dp=n_all)).resolve(n_all)
                new = healthy
            changed = [d.id for d in new] != [d.id for d in self._mesh_devices]
            key = (spec.sizes(), tuple(d.id for d in new))
            if key not in self._meshes:
                self._meshes[key] = join_mesh(spec, key[1])
            self._mesh = self._meshes[key]
            self._mesh_devices = new
            self._mesh_sizes = dict(zip(AXIS_ORDER, spec.sizes()))
            if changed:
                self._epoch += 1
                with self._lock:
                    self._executables.clear()  # compiled for the old device set

    def _mesh_shape(self) -> dict | None:
        return dict(self._mesh_sizes) if self._rank is not None else None

    @property
    def _devices(self) -> list[_Device]:
        """The mesh's devices; on one card, the devices not excluded."""
        if self._rank is not None:
            return list(self._mesh_devices)
        return [d for d in self._all_devices if d.id not in self._breaker.excluded]

    # -- TPU contract ----------------------------------------------------------
    def device_count(self) -> int:
        return len(self._devices)

    def mesh(self) -> Any:
        """The :class:`~gofr_tpu_torch.parallel.mesh.Mesh` the executables run
        over: None on one card, and on a rank the breaker excluded."""
        return self._mesh

    def compile(
        self,
        name: str,
        fn: Any,
        *example_args: Any,
        in_shardings: Any = None,
        out_shardings: Any = None,
        donate_argnums: Any = (),
        static_argnums: Any = (),
        generators: Any = (),
    ) -> _Executable:
        """Build the executable of ``fn`` for ``example_args`` (tensors, or
        ``(shape, dtype)`` specs; the positions in ``static_argnums`` are
        plain values baked in) and cache it under ``name``. A donated
        argument needs nothing here: execute copies every argument into
        the graph's own buffers. Over a mesh the examples are global and
        ``in_shardings``/``out_shardings`` place them (module docstring);
        the recipe is kept, so a failover can rebuild the executable."""
        if not self._all_devices:
            raise TPUError(f"compilation of {name} failed: not connected")
        static_argnums = tuple(static_argnums)
        if self._rank is None and (in_shardings is not None or out_shardings is not None):
            raise TPUError(f"compilation of {name} failed: shardings need a mesh (TPU_MESH "
                           "over a world of ranks); this client drives one card")
        with self._span(f"tpu.compile {name}"):
            start = time.perf_counter()
            try:
                exe, flops, captured = self._compile_local(
                    name, fn, example_args, in_shardings, out_shardings, static_argnums, generators)
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
                "captured": exe.graph is not None,
                "collectives": "refused",
                "captured_launches": captured,
                "replays": 0,
                "donate_argnums": tuple(donate_argnums),
                "mesh": self._mesh_shape(),
            }
            if self._rank is not None:
                self._recipes[name] = {
                    "fn": fn, "example_args": example_args, "in_shardings": in_shardings,
                    "out_shardings": out_shardings, "donate_argnums": donate_argnums,
                    "static_argnums": static_argnums, "generators": generators,
                    # shardings bound to a concrete mesh cannot be rebuilt on
                    # a shrunk one
                    "mesh_bound": any(s is not None and not callable(s)
                                      for s in (in_shardings, out_shardings)),
                }
        if self._logger:
            self._logger.info(f"compiled executable {name} in {elapsed:.2f}s")
        return exe

    def _compile_local(self, name: str, fn: Any, example_args: tuple, in_shardings: Any,
                       out_shardings: Any, static_argnums: tuple,
                       generators: Any) -> tuple[_Executable, float | None, dict]:
        dev = self._own
        reason = (f"executable {name}: a gloo collective runs on the host and cannot be "
                  "captured; compile the per-shard computation, and let out_shardings "
                  "assemble the result")
        if self._rank is None:
            inputs = [arg if i in static_argnums else _static_input(arg, dev)
                      for i, arg in enumerate(example_args)]
            with collectives.refused(reason):
                return self._build(fn, inputs, static_argnums, generators, dev)
        signature = [arg if i in static_argnums else _signature(arg)
                     for i, arg in enumerate(example_args)]
        mesh = self._mesh
        if mesh is None:  # outside the mesh: nothing to hold, nothing to run
            exe = _Executable(fn, [], static_argnums)
            exe.signature, exe.local = signature, False
            return exe, None, {}
        in_sh = in_shardings(mesh) if callable(in_shardings) else in_shardings
        out_sh = out_shardings(mesh) if callable(out_shardings) else out_shardings
        in_list = _per_argument(in_sh, len(example_args), "in_shardings")
        outs = list(out_sh) if isinstance(out_sh, (tuple, list)) else [out_sh]
        _per_argument(outs, len(outs), "out_shardings")
        for s in in_list + outs:
            if s is not None and s.mesh is not mesh:
                raise TPUError(
                    f"executable {name} was compiled with shardings bound to the previous "
                    "mesh; recompile it (pass callable shardings to stay rebuildable across "
                    "sick-chip failover)"
                )
        inputs = []
        for i, (arg, s) in enumerate(zip(example_args, in_list)):
            if i in static_argnums:
                inputs.append(arg)
                continue
            shape, dtype = signature[i]
            idx = local_index(shape, s.spec, mesh) if s is not None else ()
            if isinstance(arg, torch.Tensor):
                inputs.append(arg[idx].detach().to(dev, copy=True))
            else:
                local = torch.empty(shape, dtype=dtype, device="meta")[idx].shape
                inputs.append(torch.zeros(local, dtype=dtype, device=dev))
        with collectives.refused(reason):
            exe, flops, captured = self._build(fn, inputs, static_argnums, generators, dev)
        exe.placement, exe.signature = (in_list, out_sh, mesh), signature
        return exe, flops, captured

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

    def _recompile(self, name: str) -> _Executable | None:
        """Rebuild a dropped executable from its recipe (after a failover
        or a restore changed the device set); every rank calls it at the
        same point."""
        with self._lock:
            recipe = self._recipes.get(name)
        if recipe is None:
            return None
        if recipe["mesh_bound"]:
            raise TPUError(
                f"executable {name} was compiled with shardings bound to the previous mesh; "
                "recompile it (pass callable shardings to stay rebuildable across sick-chip "
                "failover)"
            )
        return self.compile(
            name, recipe["fn"], *recipe["example_args"],
            in_shardings=recipe["in_shardings"], out_shardings=recipe["out_shardings"],
            donate_argnums=recipe["donate_argnums"], static_argnums=recipe["static_argnums"],
            generators=recipe["generators"],
        )

    def get_executable(self, name: str) -> _Executable | None:
        with self._lock:
            return self._executables.get(name)

    def execute(self, name: str, *args: Any, block: bool = False) -> Any:
        """Run a cached executable into fresh outputs. Asynchronous on the
        card unless ``block=True`` (which waits for the card). Failures
        feed the breaker; over a mesh the tripping call fails over to the
        survivors and is retried."""
        self._maybe_restore()
        epoch = self._epoch
        if not self._devices:
            raise TPUError("all devices excluded by the sick-chip breaker")
        exe = self.get_executable(name)
        if exe is None and self._rank is not None:
            exe = self._recompile(name)
        if exe is None:
            raise TPUError(f"executable {name} not compiled")
        try:
            exe.check(name, args, self._own if self._rank is not None else None)
        except TPUError as exc:
            self._last_error = str(exc)
            raise
        start = time.perf_counter_ns()
        with self._span(f"tpu.execute {name}"):
            out, exc = self._run(exe, args, block)
            if exc is not None:
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

    def _run(self, exe: _Executable, args: tuple, block: bool) -> tuple[Any, Exception | None]:
        """(result, None), or (None, the failure). Over a mesh the outcome
        is agreed by every rank and the result assembled; a failure on any
        rank is every rank's, with the first failing rank's message."""
        out, exc = None, None
        try:
            if exe.local:
                out = exe.run(exe.shard_args(args))
                if block and exe.graph is not None:
                    torch.cuda.synchronize(self._own)
        except Exception as e:  # noqa: BLE001 - the device's failure, handed to the breaker
            exc = e
        if self._rank is None:
            return out, exc
        failed, message = self._agree(exc is None, exc)
        if failed:
            return None, exc if exc is not None else RuntimeError(message)
        return self._assemble(exe, out), None

    def _agree(self, ok: bool, exc: Exception | None = None) -> tuple[list[int], str | None]:
        """Every rank's flag, over the whole world: (the ranks that failed,
        the first one's message)."""
        failed = self._failed_ranks(ok)
        if not failed:
            return [], None
        messages: list = [None] * dist.get_world_size()
        dist.all_gather_object(messages, None if exc is None else str(exc))
        return failed, messages[failed[0]]

    def _failed_ranks(self, ok: bool) -> list[int]:
        """The ranks whose ``ok`` is False: one all-reduce over the world
        (a host tensor on gloo, the rank's card on NCCL)."""
        dev = self._own if dist.get_backend() == "nccl" else "cpu"
        flags = torch.ones(dist.get_world_size(), dtype=torch.int32, device=dev)
        flags[self._rank] = int(ok)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        return [r for r, f in enumerate(flags.tolist()) if not f]

    def _assemble(self, exe: _Executable, out: Any) -> Any:
        """The global result from each rank's output: each dimension an
        output sharding splits is gathered over its axes (innermost
        first); a rank outside the mesh receives the result by a broadcast
        over the world."""
        if exe.local and exe.placement is not None:
            _, out_sh, mesh = exe.placement
            if isinstance(out_sh, (tuple, list)):
                out = type(out)(_gather(o, s, mesh) for o, s in zip(out, out_sh))
            elif out_sh is not None:
                out = _gather(out, out_sh, mesh)
        if len(self._mesh_devices) == dist.get_world_size():
            return out
        box = [tree_util.tree_map(
            lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, out) if exe.local else None]
        dist.broadcast_object_list(box, src=self._mesh_devices[0].id)
        if exe.local:
            return out
        return tree_util.tree_map(
            lambda t: t.to(self._own) if isinstance(t, torch.Tensor) else t, box[0])

    def _probe_device(self, device: _Device) -> bool:
        """One tiny op on the device: does it still answer?"""
        x = torch.ones(8, dtype=torch.float32, device=device.device)
        return bool((x + 1).cpu()[0] == 2.0)

    def _probe_devices_safely(self, devices: list, timeout_s: float = 5.0) -> list[int]:
        """Probe every device through its persistent prober under one
        shared deadline (a wedged device HANGS rather than raises). At
        most one thread per device for the client's lifetime: a device
        whose previous probe never returned is reported failed without
        spawning anything. Returns the ids that failed to answer. Over a
        mesh each rank probes its own device and the results are agreed
        over the whole world, so every rank returns the same ids."""
        mine = [d for d in devices if self._rank is None or d.id == self._rank]
        failed: list[int] = []
        pending: list[_DeviceProber] = []
        for d in mine:
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
        if self._rank is None:
            return failed
        probed = {d.id for d in devices}
        return [r for r in self._failed_ranks(self._rank not in failed) if r in probed]

    def _on_execute_failure(self, name: str, args: tuple, block: bool, exc: Exception,
                            epoch: int | None = None) -> Any:
        """Breaker bookkeeping and failover. Below the threshold the caller
        gets the typed 503. The failure that trips it probes the devices:
        all healthy is a typed "all devices probe healthy" error (bad
        input, OOM, a bug); the failed ones are excluded. On one card
        nothing is left to retry on. Over a mesh the mesh is rebuilt over
        the survivors, the executable recompiled from its recipe, and THIS
        call retried. A failure dispatched before the device set last
        changed skips the breaker and retries on the current set."""
        newly: list[int] = []
        with self._failover_lock:
            if epoch is not None and epoch != self._epoch:
                retry = self.get_executable(name) if self._devices else None
                if retry is None and self._rank is not None and self._devices:
                    retry = self._recompile(name)
                if retry is None:
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
                if self._metrics:
                    for did in newly:
                        self._metrics.increment_counter(
                            "app_tpu_devices_excluded_total", device=str(did)
                        )
                if self._rank is None:
                    self._epoch += 1
                    if self._logger:
                        self._logger.error(
                            f"sick-chip breaker tripped on device(s) {newly} after repeated "
                            f"failures of {name}; no healthy device is left"
                        )
                    raise TPUError("all devices excluded by the sick-chip breaker") from exc
                if self._logger:
                    self._logger.error(
                        f"sick-chip breaker tripped on device(s) {newly} after repeated "
                        f"failures of {name}; rebuilding mesh over "
                        f"{len(self._all_devices) - len(self._breaker.excluded)} healthy device(s)"
                    )
                try:
                    self._rebuild_mesh()
                    retry = self._recompile(name)
                except TPUError:
                    raise
                except Exception as rexc:
                    raise TPUError(
                        f"failover after excluding device(s) {newly} failed: {rexc}"
                    ) from rexc
                if retry is None:
                    raise TPUError(f"execution of {name} failed: {exc}") from exc
        retry_start = time.perf_counter_ns()
        with self._span(f"tpu.execute {name} (failover)"):
            out, rexc = self._run(retry, args, block)
            if rexc is not None:
                self._last_error = f"execute {name} (failover): {rexc}"
                raise TPUError(f"execution of {name} failed even after failover: {rexc}") from rexc
        if self._logger and newly:
            self._logger.warn(f"request recovered on shrunk mesh after excluding {newly}")
        self._breaker.record_success(name)
        self._last_error = None
        self._observe_execution(name, time.perf_counter_ns() - retry_start)
        return out

    def _maybe_restore(self, timeout_s: float = 5.0) -> None:
        """Half-open probe: after the cooldown, bring the excluded devices
        back. On one card the device is probed first, and one that does
        not answer starts a new cooldown. Over a mesh the cooldown is
        agreed by every rank (an all-reduce while any device is excluded)
        and the full mesh is restored optimistically, as the reference
        restores it: a device still sick re-trips. Double-checked under
        the failover lock."""
        if not self._breaker.excluded:
            return
        if self._rank is not None:
            if self._failed_ranks(self._breaker.cooldown_elapsed()):
                return
            with self._failover_lock:
                restored = sorted(self._breaker.excluded)
                self._breaker.reset()
                self._rebuild_mesh()
            if self._logger:
                self._logger.info(f"sick-chip breaker cooldown elapsed; probing previously "
                                  f"excluded device(s) {restored}")
            return
        if not self._breaker.cooldown_elapsed():
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
        """Each device's memory: on one card the card's; over a mesh this
        rank's own device's (another rank's is another process's)."""
        from gofr_tpu_torch.serving.device_telemetry import card_memory

        per_device = []
        for d in self._devices if self._rank is None else [
                d for d in self._all_devices if d.id == self._rank]:
            mem = {"used": 0, "limit": 0, "peak": 0}
            if d.platform == "gpu":
                mem = card_memory(d.device.index if d.device is not None else d.id)
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
            "mesh": self._mesh_shape(),
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


def _gather(x: torch.Tensor, sharding: NamedSharding | None, mesh: Any) -> torch.Tensor:
    """The global tensor from this rank's shard of it: each split dimension
    gathered over its axes, the innermost first (``local_index``'s order)."""
    if sharding is None:
        return x
    for dim, entry in enumerate(sharding.spec):
        for axis in reversed(entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                x = collectives.all_gather(x, mesh, axis, dim)
    return x


def _signature(arg: Any) -> tuple[tuple[int, ...], torch.dtype]:
    """The global (shape, dtype) of an example: a tensor, or a spec."""
    if isinstance(arg, torch.Tensor):
        return tuple(arg.shape), arg.dtype
    if (isinstance(arg, (tuple, list)) and len(arg) == 2
            and isinstance(arg[1], torch.dtype)):
        return tuple(arg[0]), arg[1]
    raise TypeError(
        f"an example argument must be a tensor or a (shape, dtype) spec, not {arg!r}"
    )


def _static_input(arg: Any, dev: torch.device) -> torch.Tensor:
    """The executable's own buffer for one argument: a copy of an example
    tensor, or zeros for a ``(shape, dtype)`` spec."""
    if isinstance(arg, torch.Tensor):
        return arg.detach().to(dev, copy=True)
    shape, dtype = _signature(arg)
    return torch.zeros(shape, dtype=dtype, device=dev)


def new_tpu(config: Any, *, device: str | torch.device | None = None) -> TPUClient:
    return TPUClient.from_config(config, device=device)
