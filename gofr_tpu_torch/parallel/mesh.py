"""The named mesh of ranks (port of ``gofr_tpu/parallel/mesh.py``).

One process is one rank of a ``torch.distributed`` world
(``parallel/world.py``). A :class:`Mesh` lays the world's ranks out on the
reference's fixed axes, in its order, outermost first:

- ``dp``  — data parallel (batch sharding)
- ``fsdp`` — fully-sharded data parallel (weights sharded over the group,
  gathered at use)
- ``pp``  — pipeline stages
- ``sp``  — sequence/context parallel (ring and Ulysses attention)
- ``ep``  — expert parallel (MoE dispatch axis)
- ``tp``  — tensor parallel (Megatron-style weight sharding), innermost

``TPU_MESH``'s grammar (``dp=2,tp=4``, one ``-1`` wildcard) is the
reference's, error for error. Axes of size 1 are kept: rules may name
them, and every collective over one is the identity without a call.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "ep", "tp")

#: the fixed axis vocabulary, as a set; require_axis() is the runtime
#: check for axis names that only exist as values.
KNOWN_AXES = frozenset(AXIS_ORDER)


def require_axis(mesh: "Mesh", axis: str) -> int:
    """Validate that ``axis`` names an axis of ``mesh`` and return its
    size. A plain ``mesh.shape[axis]`` raises a bare KeyError; this raises
    at the SPMD wrapper boundary with the vocabulary spelled out."""
    if axis not in mesh.shape:
        raise ValueError(
            f"axis {axis!r} is not an axis of the mesh "
            f"(mesh axes: {', '.join(mesh.axis_names)}; "
            f"framework vocabulary: {', '.join(AXIS_ORDER)})"
        )
    return mesh.shape[axis]


@dataclasses.dataclass
class MeshSpec:
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """Parse ``"dp=2,tp=4"`` (TPU_MESH config value)."""
        spec = cls()
        if not text:
            return spec
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            m = re.match(r"^(dp|fsdp|pp|sp|ep|tp)\s*=\s*(-?\d+)$", part)
            if not m:
                raise ValueError(f"bad TPU_MESH entry: {part!r}")
            setattr(spec, m.group(1), int(m.group(2)))
        return spec

    def sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def total(self) -> int:
        return math.prod(s for s in self.sizes() if s > 0)

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill a single ``-1`` axis with the leftover device count (like a
        reshape wildcard); validate the product matches."""
        sizes = list(self.sizes())
        if sizes.count(-1) > 1:
            raise ValueError("at most one TPU_MESH axis may be -1")
        if -1 in sizes:
            known = math.prod(s for s in sizes if s != -1)
            if n_devices % known != 0:
                raise ValueError(f"{n_devices} devices not divisible by mesh product {known}")
            sizes[sizes.index(-1)] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"TPU_MESH product {math.prod(sizes)} != device count {n_devices}"
            )
        return MeshSpec(**dict(zip(AXIS_ORDER, sizes)))


class Mesh:
    """The world's ranks on the named axes, seen from this rank.

    ``shape`` (axis → size), ``axis_names`` and ``devices`` (the grid of
    global ranks, ``devices.shape`` the sizes in ``AXIS_ORDER``) are the
    reference's. ``group(axis)`` is the process group of this rank's
    line along ``axis`` and ``index(axis)`` its place on it (the
    counterpart of ``jax.lax.axis_index``). Over more than one rank the
    groups come from a ``torch.distributed`` ``DeviceMesh`` with
    ``mesh_dim_names=AXIS_ORDER``; a mesh of one rank needs no process
    group, and has none."""

    def __init__(self, grid: np.ndarray, device_type: str) -> None:
        self.devices = grid
        self.axis_names = AXIS_ORDER
        self.shape = dict(zip(AXIS_ORDER, grid.shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(grid == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not on the mesh {grid.tolist()}")
        self.coordinate = dict(zip(AXIS_ORDER, (int(c) for c in where[0])))
        self.device_mesh = None
        if grid.size > 1:
            from torch.distributed.device_mesh import DeviceMesh

            self.device_mesh = DeviceMesh(device_type, torch.as_tensor(grid),
                                          mesh_dim_names=AXIS_ORDER)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1) or "one rank"
        return f"Mesh({axes}; rank {self.rank} at {self.coordinate})"

    def index(self, axis: str) -> int:
        require_axis(self, axis)
        return self.coordinate[axis]

    def group(self, axis: str) -> Any:
        """The process group along ``axis``; None for an axis of size 1,
        whose collectives are the identity."""
        if require_axis(self, axis) == 1:
            return None
        return self.device_mesh.get_group(axis)

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, by index."""
        at = tuple(slice(None) if a == axis else self.coordinate[a] for a in AXIS_ORDER)
        return [int(r) for r in self.devices[at]]


def build_mesh(spec: MeshSpec | str | None = None, devices: Sequence[int] | None = None) -> Mesh:
    """A named Mesh over ``devices``, the world's global ranks (every rank
    of the world by default; one rank when no process group is up).
    Every rank of the world calls it with the same arguments. Axes of size
    1 are kept: sharding rules can always name them."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized() else 1)
    return Mesh(_grid(spec, devices), _device_type())


def join_mesh(spec: MeshSpec | str | None, devices: Sequence[int]) -> Mesh | None:
    """:func:`build_mesh` over ``devices``, some of the world's ranks, called
    by EVERY rank of the world with the same arguments: a mesh's groups are
    made collectively over the whole world. A rank outside ``devices``
    takes part in making them and gets None (it holds no place on the
    mesh)."""
    if not dist.is_initialized() or dist.get_rank() in devices:
        return build_mesh(spec, devices)
    grid = _grid(spec, devices)
    if grid.size > 1:
        from torch.distributed.device_mesh import DeviceMesh

        DeviceMesh(_device_type(), torch.as_tensor(grid), mesh_dim_names=AXIS_ORDER)
    return None


def _grid(spec: MeshSpec | str | None, devices: Sequence[int]) -> np.ndarray:
    """The ranks laid out on the axes, in ``AXIS_ORDER``."""
    if isinstance(spec, str):
        spec = MeshSpec.parse(spec)
    devices = list(devices)
    spec = (spec or MeshSpec(dp=len(devices))).resolve(len(devices))
    return np.asarray(devices, dtype=np.int64).reshape(spec.sizes())


def _device_type() -> str:
    return "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"


def local_mesh(**axes: int) -> Mesh:
    """Convenience for tests: ``local_mesh(tp=4, dp=2)`` over however many
    ranks the world has."""
    spec = MeshSpec(**axes)
    return build_mesh(spec)
