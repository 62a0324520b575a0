"""All-reduce and all-gather through shared host memory, for the ranks of
one gloo group that share a host.

Gloo moves every collective through TCP on loopback. On the host of an
NVIDIA H100 80GB HBM3 (``tools_torch/collective_probe.py``, four ranks)
a 4-byte all-reduce took 1.85 ms and a decode step's 128 KB one 6.5 ms,
where the ring's took 0.32 ms. The tensor-parallel engine runs two
all-reduces a layer, so over gloo a one-card world of four ranks spent
about a second a decode step in them. A :class:`HostRing` replaces those two
collectives for a group whose ranks are all on this host: one shared
memory segment with a slot and a flag per rank, twice (double buffering),
and a spin on the flags in place of the network.

- ``all_reduce``: each rank copies its tensor to its slot and publishes
  the call's sequence number in its flag; once every flag has it, each
  rank sums all the slots **in rank order**, so every rank holds the same
  bits. A tensor past the slot goes through in slot-sized pieces, one
  exchange each: one algorithm for every size.
- ``all_gather``: the same exchange, the slots concatenated.
- Two buffers alternate by the sequence number's parity: a rank writes a
  buffer again only two calls later, and the call between needs every
  rank's flag, which a rank raises only after it has read the buffer.
- Failure: :func:`abort_all` (the tensor-parallel group's abort) raises a
  shared abort flag, a rank checks its peers' processes every 0.1 s while
  it waits, and a wait longer than the group's timeout raises. A waiting
  peer raises instead of hanging.

The ring moves bytes with numpy and adds with numpy (bf16: in pieces of
at most ``_GRAIN`` elements), so no operation of it spreads over PyTorch's
intra-op threads, which four ranks of a pool each would oversubscribe on
the host's cores.

Memory order: a rank stores its data, then its flag, with plain stores,
and a peer loads the flag, then the data. Only a host that keeps stores
in order and loads in order (x86-64's total store order) makes that
safe, so :func:`ring_for` builds a ring on an x86-64 host only; elsewhere
(an aarch64 host, say) the group stays on gloo.

The segment is unlinked as soon as every rank has mapped it, so nothing
is left in ``/dev/shm`` if a rank dies. Used by ``parallel.collectives``
for gloo groups only, and only when every rank of the group reports this
host's name; NCCL keeps its own transport.
"""

from __future__ import annotations

import _posixshmem
import datetime
import mmap
import os
import platform
import secrets
import socket
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

SLOT_BYTES = 4 << 20  # a slot a rank a buffer; larger tensors go in pieces
_GRAIN = 16384  # elements an add: below PyTorch's parallel grain, one thread
_WORD = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}  # dtype-blind moves
_NUMPY_ADD = (torch.float32, torch.float64, torch.float16)  # numpy adds as torch does
_POLL_S = 0.1  # while waiting, check the peers' processes this often
# hosts whose plain stores and loads each stay in program order (see the
# module docstring)
_ORDERED_HOSTS = ("x86_64", "amd64")

class HostRingError(RuntimeError):
    """A peer aborted or died, or the wait passed the group's timeout."""


def _timeout_s(group: Any) -> float:
    try:  # the group's own timeout (torch >= 2.3 names it on the options)
        timeout = group.options._timeout
        if isinstance(timeout, datetime.timedelta):
            return timeout.total_seconds()
    except AttributeError:
        pass
    return 600.0


class HostRing:
    """The shared segment of one group (see the module docstring). Every
    rank of ``group`` constructs it at the same point."""

    def __init__(self, group: Any) -> None:
        ranks = dist.get_process_group_ranks(group)
        self.n = len(ranks)
        self.me = ranks.index(dist.get_rank())
        self.timeout_s = _timeout_s(group)
        # the flags: one int64 a rank, then the abort flag, in whole cache
        # lines
        self._header = -(-(self.n + 1) * 8 // 64) * 64
        name = [f"gofr_ring_{os.getpid()}_{secrets.token_hex(6)}" if self.me == 0 else None]
        dist.broadcast_object_list(name, src=ranks[0], group=group)
        size = self._header + 2 * self.n * SLOT_BYTES
        if self.me == 0:  # a new segment is zero-filled: every flag starts at 0
            fd = _posixshmem.shm_open(name[0], os.O_CREAT | os.O_EXCL | os.O_RDWR, mode=0o600)
            os.ftruncate(fd, size)
            self._buf = mmap.mmap(fd, size)
            os.close(fd)
        dist.barrier(group=group)
        if self.me != 0:
            fd = _posixshmem.shm_open(name[0], os.O_RDWR, mode=0o600)
            self._buf = mmap.mmap(fd, size)
            os.close(fd)
        pids = [None] * self.n
        dist.all_gather_object(pids, os.getpid(), group=group)
        if self.me == 0:  # mapped everywhere now: the name goes, the memory stays
            _posixshmem.shm_unlink(name[0])
        self._pids = [p for i, p in enumerate(pids) if i != self.me]
        self._flags = np.ndarray((self.n + 1,), np.int64, self._buf, 0)
        self._seq = 0

    def _offset(self, buffer: int, rank: int) -> int:
        """Rank ``rank``'s slot of ``buffer``."""
        return self._header + (buffer * self.n + rank) * SLOT_BYTES

    def _words(self, buffer: int, rank: int, word: Any, count: int) -> np.ndarray:
        return np.ndarray((count,), word, self._buf, self._offset(buffer, rank))

    def _tensor(self, buffer: int, rank: int, dtype: torch.dtype, count: int) -> torch.Tensor:
        return torch.frombuffer(self._buf, dtype=dtype, count=count,
                                offset=self._offset(buffer, rank))

    def _exchange(self, words: np.ndarray) -> int:
        """Publish ``words`` (at most a slot) in this rank's slot of the next
        buffer and wait for every rank's: the buffer."""
        self._seq += 1
        buffer = self._seq & 1
        np.copyto(self._words(buffer, self.me, words.dtype, words.size), words)
        self._publish()
        return buffer

    def _publish(self) -> None:
        """Raise this rank's flag to the call's number, after the data it
        announces (the host keeps store order: see the module docstring),
        and wait until every rank's has it."""
        flags = self._flags
        flags[self.me] = self._seq
        mine = slice(0, self.n)
        abort = self.n
        t0 = time.monotonic()
        t_end = t0 + self.timeout_s
        t_poll = t0 + _POLL_S
        spins = 0
        while int(flags[mine].min()) < self._seq:
            if flags[abort]:
                raise HostRingError("a rank of the group aborted")
            spins += 1
            if spins > 256:
                now = time.monotonic()
                # yield, then past a millisecond sleep: a peer may be waiting
                # for this core
                time.sleep(0 if now - t0 < 1e-3 else 5e-5)
                if now > t_poll:
                    t_poll = now + _POLL_S
                    self._check_peers()
                    if now > t_end:
                        raise HostRingError(f"no peer arrived within {self.timeout_s:g} s")

    def _check_peers(self) -> None:
        for pid in self._pids:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                raise HostRingError(f"rank process {pid} of the group is gone") from None
            except PermissionError:
                pass

    @staticmethod
    def _host_words(x: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
        """``x`` flat and contiguous on the host, and its elements as
        unsigned words of their size (numpy has no bf16)."""
        flat = x.detach().reshape(-1)
        flat = flat.cpu() if flat.is_cuda else flat.contiguous()
        return flat, flat.view(torch.uint8).numpy().view(_WORD[flat.element_size()])

    def _pieces(self, numel: int, itemsize: int):
        step = max(1, SLOT_BYTES // itemsize)
        return [(i, min(step, numel - i)) for i in range(0, numel, step)] or [(0, 0)]

    @staticmethod
    def _add(acc: torch.Tensor, src: torch.Tensor) -> None:
        if acc.dtype in _NUMPY_ADD:  # one vectorized pass on this thread
            np.add(acc.numpy(), src.numpy(), out=acc.numpy())
            return
        for i in range(0, acc.numel(), _GRAIN):
            acc[i:i + _GRAIN] += src[i:i + _GRAIN]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, the same bits on every rank."""
        flat, words = self._host_words(x)
        dtype, word = flat.dtype, words.dtype
        # pinned for a card's tensor: the copy back is queued, not waited
        # for (the caching host allocator keeps the block until it ran)
        out = torch.empty_like(flat, pin_memory=x.is_cuda)
        out_words = out.view(torch.uint8).numpy().view(word)
        for at, numel in self._pieces(flat.numel(), flat.element_size()):
            buffer = self._exchange(words[at:at + numel])
            np.copyto(out_words[at:at + numel], self._words(buffer, 0, word, numel))
            for r in range(1, self.n):
                self._add(out[at:at + numel], self._tensor(buffer, r, dtype, numel))
        return out.reshape(x.shape).to(x.device, non_blocking=True)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        flat, words = self._host_words(x)
        word = words.dtype
        parts = np.empty((self.n, flat.numel()), word)
        for at, numel in self._pieces(flat.numel(), flat.element_size()):
            buffer = self._exchange(words[at:at + numel])
            for r in range(self.n):
                np.copyto(parts[r, at:at + numel], self._words(buffer, r, word, numel))
        shape = tuple(x.shape)
        dim %= len(shape)
        whole = np.moveaxis(parts.reshape((self.n,) + shape), 0, dim)
        whole = np.ascontiguousarray(whole).reshape(
            shape[:dim] + (self.n * shape[dim],) + shape[dim + 1:])
        return torch.from_numpy(whole).view(flat.dtype).to(x.device)

    def abort(self) -> None:
        self._flags[self.n] = 1


def abort_all() -> None:
    """Raise the abort flag of every ring this process is in: each peer's
    wait raises at once."""
    for _group, ring in list(_RINGS.values()):
        if ring is not None:
            ring.abort()


_RINGS: dict = {}  # id(group) -> (group, its ring or None); the group kept alive


def ring_for(group: Any) -> HostRing | None:
    """The ring of a gloo ``group`` whose ranks share this host (built on
    first use, collectively), or None: another backend, ranks on other
    hosts, or a host that does not keep memory order (see the module
    docstring)."""
    key = id(group)
    if key in _RINGS:
        return _RINGS[key][1]
    ring = None
    if dist.get_backend(group) == "gloo" and platform.machine().lower() in _ORDERED_HOSTS:
        hosts = [None] * dist.get_world_size(group)
        dist.all_gather_object(hosts, socket.gethostname(), group=group)
        if len(set(hosts)) == 1:
            ring = HostRing(group)
    _RINGS[key] = (group, ring)
    return ring
