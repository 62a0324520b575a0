"""Probe what a world of two ranks can use on one card.

    python3 tools_torch/nccl_probe.py

Needs a CUDA card. Two checks, each in a world of two spawned ranks that
share ``cuda:0``:

1. ``nccl``: both ranks call ``init_process_group("nccl")`` directly (the
   port's ``init_parallel`` refuses NCCL on a shared card before any NCCL
   call) and all-reduce one bf16 tensor; prints what NCCL did, a result or
   the error, within a deadline;
2. ``gloo`` on CUDA tensors through the port's collectives
   (``parallel/collectives.py``): a bf16 ``psum`` (gloo's own CUDA
   all-reduce) and the staged ``all_gather``, ``all_to_all`` and
   ``ppermute``, each held to the value it must have.

Prints one JSON line per check. The card's phase in ``chip_smoke.py`` does
not run this probe.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def nccl_rank(rank: int, port: int, results) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    t0 = time.perf_counter()
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.full((4,), float(rank + 1), device="cuda", dtype=torch.bfloat16)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        results.put((rank, "ok", x.tolist(), time.perf_counter() - t0))
    except BaseException:  # noqa: BLE001 - the probe reports whatever happened
        results.put((rank, "error", traceback.format_exc()[-1500:], time.perf_counter() - t0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def probe_nccl(deadline_s: float = 120.0) -> dict:
    import multiprocessing as mp

    from gofr_tpu_torch.parallel.world import free_port

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    import nccl_probe  # this file by its module name: a spawned rank imports it

    procs = [ctx.Process(target=nccl_probe.nccl_rank, args=(r, port, results), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    out: dict = {}
    end = time.monotonic() + deadline_s
    while len(out) < 2 and time.monotonic() < end:
        try:
            rank, status, value, secs = results.get(timeout=1.0)
        except Exception:  # noqa: BLE001 - queue.Empty: wait on
            continue
        out[rank] = {"status": status, "value": value, "s": round(secs, 3)}
    hung = [r for r in range(2) if r not in out]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(timeout=min(10.0, max(1.0, end - time.monotonic())))
    return {"nccl_two_ranks_one_card": out, "hung_ranks": hung,
            "exit_codes": [p.exitcode for p in procs]}


def gloo_cuda_rank(dev):
    import torch

    from gofr_tpu_torch.parallel import build_mesh
    from gofr_tpu_torch.parallel.collectives import all_gather, all_to_all, ppermute, psum

    mesh = build_mesh("tp=2")
    r = mesh.index("tp")
    x = torch.full((2, 4), float(r + 1), device=dev, dtype=torch.bfloat16)
    checks = {
        "psum": psum(x, mesh, "tp").float().tolist() == torch.full((2, 4), 3.0).tolist(),
        "all_gather": all_gather(x, mesh, "tp", 0)[:, 0].float().tolist() == [1.0, 1.0, 2.0, 2.0],
        "all_to_all": all_to_all(torch.arange(4.0, device=dev).reshape(2, 2) + 10 * r, mesh, "tp",
                                 0, 1).tolist() == ([[0.0, 1.0, 10.0, 11.0]] if r == 0
                                                    else [[2.0, 3.0, 12.0, 13.0]]),
        "ppermute": ppermute(x, mesh, "tp", [(0, 1), (1, 0)]).float()[0, 0].item() == float(2 - r),
    }
    return {"device": str(dev), "checks": checks}


def main() -> int:
    import torch

    from gofr_tpu_torch.parallel.world import run_spmd

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "card": torch.cuda.get_device_name(0), "cards": torch.cuda.device_count()}))
    print(json.dumps(probe_nccl()))
    t0 = time.perf_counter()
    import nccl_probe

    gloo = run_spmd(nccl_probe.gloo_cuda_rank, 2, backend="gloo", timeout_s=180)
    print(json.dumps({"gloo_cuda": gloo, "s": round(time.perf_counter() - t0, 2)}))
    return 0 if all(all(g["checks"].values()) for g in gloo) else 1


if __name__ == "__main__":
    sys.exit(main())
