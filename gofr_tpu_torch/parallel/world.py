"""The world of ranks: one process per rank over ``torch.distributed``.

The reference is single-controller (one process drives every chip and the
compiler places the collectives). The port is SPMD the PyTorch way: each
rank is a process that holds its own shards and calls the collectives
itself (``parallel/collectives.py``).

- :func:`init_parallel` joins this process to the world named by the
  environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_WORLD_SIZE``) and pins the
  rank's device. The card is the default; ``device="cpu"`` is the opt-in.
  The backend is explicit: ``nccl`` by default on the card, ``gloo`` on
  the CPU. NCCL takes one card a rank, so when ranks would share a card it
  raises before any NCCL call, naming ``backend="gloo"``; nothing switches
  the backend on its own.
- :func:`run_spmd` runs ``fn(device, *args)`` on every rank of a fresh
  world of spawned processes and returns each rank's result, or raises
  with the traceback of the first rank that failed. It has a hard
  deadline: on expiry it kills every rank and raises, so nothing waits on
  a rank that hangs in a collective. ``fn`` must be importable by name
  from a module (not ``__main__``): spawned ranks start from a fresh
  interpreter. On the card the kernels are built before the ranks start,
  so the ranks only load them.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from gofr_tpu_torch._device import resolve_device

BACKENDS = ("nccl", "gloo")


class SpmdError(RuntimeError):
    """A rank raised, died or missed the deadline; the message carries the
    rank's traceback or exit code."""


def init_parallel(
    backend: str | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the world named by the environment and return this rank's
    device: ``cuda:<local rank mod cards>`` (the card unless the caller
    passes ``"cpu"``; without a card that raises). ``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: must be one of {', '.join(BACKENDS)}")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > cards:
            raise ValueError(
                f"backend='nccl' takes one card a rank, and {local_world} ranks would share "
                f"{cards} card(s) here; pass backend='gloo' to run them on shared cards"
            )
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("backend='nccl' needs the card; pass backend='gloo' with device='cpu'")
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str | None, device: Any,
               timeout_s: float, work: Any, results: Any) -> None:
    """A spawned rank: join the world, take ``(fn, args)`` from ``work``,
    run it, report (rank, ok, value)."""
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
    })
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # one core a rank: ranks outnumber cores
    try:
        fn, args = work.get()
        value = fn(init_parallel(backend, device, timeout_s), *args)
    except BaseException:  # noqa: BLE001 - the rank's boundary: report and end
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, value))
    finally:  # after the report: a peer's collective fails once this rank leaves
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(world: int, errors: dict[int, str], results: Any) -> str:
    """Every rank's traceback that arrives within a second of the first:
    a rank that raises ends the collectives its peers wait in, and their
    errors follow its own."""
    end = time.monotonic() + 1.0
    while time.monotonic() < end:
        try:
            rank, ok, value = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            errors[rank] = value
    return "\n".join(f"run_spmd: rank {r} of {world} raised:\n{tb}" for r, tb in sorted(errors.items()))


def _kill(procs: list) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(timeout=10)


def run_spmd(
    fn: Callable[..., Any],
    world: int,
    *,
    args: tuple = (),
    backend: str | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = 300.0,
) -> list[Any]:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks and return the
    results by rank. Raises :class:`SpmdError` with the first failing
    rank's traceback, or when a rank dies without a result, and kills every
    rank when ``timeout_s`` passes first. ``args`` and the results cross
    process boundaries by pickling: pass CPU tensors or arrays."""
    import multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda":
        from gofr_tpu_torch import _build

        _build.build_all()  # once, here: the ranks load what this built
    ctx = mp.get_context("spawn")
    # the work goes through a queue, not the Process arguments: a start
    # blocks until its child has read those, imports included, so large
    # arguments would start the ranks one after another
    work, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main, name=f"spmd-rank-{r}", daemon=True,
                    args=(r, world, port, backend, str(dev), timeout_s, work, results))
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout_s
    out: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        for _ in procs:
            work.put((fn, args))
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise SpmdError(
                    f"run_spmd: {world - len(out)} of {world} ranks had no result after "
                    f"{timeout_s:.0f} s; every rank killed"
                )
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [p for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:  # give its report a moment to arrive through the pipe
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise SpmdError(
                            f"run_spmd: {dead[0].name} exited with code {dead[0].exitcode} "
                            "and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise SpmdError(_failures(world, {rank: value}, results))
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _kill(procs)
        for q in (work, results):
            q.close()
            q.cancel_join_thread()  # a killed rank may leave work unread
    return [out[r] for r in range(world)]
