"""Collectives over a mesh axis: the port's ``jax.lax`` collectives.

Every function takes a tensor that is this rank's value, the
:class:`~gofr_tpu_torch.parallel.mesh.Mesh` and an axis name, and returns
this rank's result. Over an axis of size 1 each is the identity (or the
only chunk) without a call. Each is a ``torch.autograd.Function`` with
the transpose rule the reference's compiler applies:

- :func:`psum` (sum; backward the identity), :func:`pmean` (the mean;
  backward scaled by 1/n), :func:`copy_to` (the identity; backward a sum):
  ``copy_to`` before a column-parallel matmul and ``psum`` after a
  row-parallel one are Megatron's pair;
- :func:`all_gather` (tiled; backward a reduce-scatter of the sum, as
  JAX's transpose), :func:`gather_from` (tiled; backward this rank's
  chunk: for a result every rank consumes the same way) and
  :func:`split_to` (this rank's chunk; backward an all-gather);
- :func:`all_to_all` (tiled; backward the reverse exchange) and
  :func:`ppermute` (backward the inverse permutation).

Backends: NCCL takes CUDA tensors. Gloo takes CPU tensors, and on CUDA
tensors only ``all_reduce`` and ``broadcast``: the others stage a CUDA
tensor through a host copy, and only because the world runs gloo on the
card (one card shared by every rank). On a gloo group whose ranks share a
host, the all-reduce and the all-gather (the sums and gathers above and
their transposes) go through shared memory instead of loopback TCP
(``parallel/hostring.py``, on an x86-64 host). A backward runs the same
collectives in the same order on every rank only if every rank builds the
same graph: callers keep each collective's output in use on every rank
(a zero-weighted use is enough).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch
import torch.distributed as dist

from gofr_tpu_torch.parallel.hostring import ring_for
from gofr_tpu_torch.parallel.mesh import Mesh, require_axis


_refusal = threading.local()


@contextlib.contextmanager
def refused(reason: str):
    """Within the block, on this thread, every collective below raises
    ``RuntimeError`` naming ``reason`` before it communicates (an axis of
    size 1 too): the device client's ``compile`` runs a function under it,
    since a gloo collective runs on the host and cannot be captured."""
    before = getattr(_refusal, "reason", None)
    _refusal.reason = reason
    try:
        yield
    finally:
        _refusal.reason = before


def _allowed(name: str) -> None:
    reason = getattr(_refusal, "reason", None)
    if reason is not None:
        raise RuntimeError(f"{name}: a collective is refused here ({reason})")


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's place on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.index(axis)


def _staged(x: torch.Tensor, group: Any) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    ring = ring_for(group)
    if ring is not None:
        return ring.all_reduce(x)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group: Any, n: int, dim: int) -> torch.Tensor:
    ring = ring_for(group)
    if ring is not None:
        return ring.all_gather(x, dim)
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _chunk(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


def _reduce_scatter(x: torch.Tensor, group: Any, n: int, i: int, dim: int) -> torch.Tensor:
    if dist.get_backend(group) == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    # gloo has no reduce-scatter: the sum everywhere, then this rank's chunk
    return _chunk(_all_reduce(x, group), n, i, dim).contiguous()


def _all_to_all(x: torch.Tensor, group: Any, n: int, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    src = x.movedim(split_axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split {n} ways")
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    parts = [p.movedim(0, split_axis) for p in out.chunk(n, dim=0)]
    return torch.cat(parts, dim=concat_axis).to(x.device)


def _ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm: list[tuple[int, int]]) -> torch.Tensor:
    group = mesh.group(axis)
    ranks = mesh.axis_ranks(axis)
    me = mesh.index(axis)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = torch.zeros_like(src)  # a rank nothing is sent to receives zeros
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], group=group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group=group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = _all_reduce(x, group)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i, dim, replicated):
        ctx.args = (group, n, i, dim, replicated)
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, i, dim, replicated = ctx.args
        if replicated:
            return _chunk(g, n, i, dim).contiguous(), None, None, None, None, None
        return _reduce_scatter(g, group, n, i, dim), None, None, None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i, dim):
        ctx.args = (group, n, dim)
        return _chunk(x, n, i, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _all_gather(g, group, n, dim), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, n, concat_axis, split_axis), None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, inverse = ctx.args
        return _ppermute(g, mesh, axis, inverse), None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` on every rank (``jax.lax.psum``); backward
    passes the cotangent through (the result is the same on every rank)."""
    _allowed("psum")
    if require_axis(mesh, axis) == 1:
        return x
    return _Psum.apply(x, mesh.group(axis), 1.0)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str | tuple[str, ...]) -> torch.Tensor:
    """The mean over one axis or several (``jax.lax.pmean``)."""
    _allowed("pmean")
    for a in (axis,) if isinstance(axis, str) else axis:
        n = require_axis(mesh, a)
        if n > 1:
            x = _Psum.apply(x, mesh.group(a), 1.0 / n)
    return x


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The identity; backward sums the cotangent over ``axis``. Put before
    a computation each rank of ``axis`` does on its own shard of weights
    with the same replicated input."""
    _allowed("copy_to")
    if require_axis(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh.group(axis))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``); backward reduce-scatters
    the summed cotangent (each rank's use of the whole is partial)."""
    _allowed("all_gather")
    n = require_axis(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), n, mesh.index(axis), dim % x.dim(), False)


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """:func:`all_gather` for a result every rank of ``axis`` then uses
    the same way: backward keeps this rank's chunk of the cotangent."""
    _allowed("gather_from")
    n = require_axis(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), n, mesh.index(axis), dim % x.dim(), True)


def split_to(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's chunk of a replicated ``x`` along ``dim``; backward
    all-gathers the cotangent (the other chunks' gradients come from their
    ranks)."""
    _allowed("split_to")
    n = require_axis(mesh, axis)
    if n == 1:
        return x
    return _SplitTo.apply(x, mesh.group(axis), n, mesh.index(axis), dim % x.dim())


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    chunk j of ``split_axis`` goes to rank j; the chunks received are
    concatenated along ``concat_axis`` in source order."""
    _allowed("all_to_all")
    n = require_axis(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.group(axis), n, split_axis % x.dim(), concat_axis % x.dim())


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm: list[tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: rank ``s`` of ``axis`` sends ``x`` to rank
    ``d`` for each ``(s, d)`` in ``perm``; a rank no pair names as a
    destination gets zeros. Point-to-point (``batch_isend_irecv``)."""
    _allowed("ppermute")
    if require_axis(mesh, axis) == 1:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh, axis, [(int(s), int(d)) for s, d in perm])
