"""What a collective costs a world of four ranks on the one card: gloo's
loopback TCP against the shared-memory host ring (``parallel/hostring.py``)
that ``parallel.collectives`` uses for a one-host gloo group, and one
tensor-parallel decode step (8B widths, 4 layers, paged bf16) against the
same step on one card.

    python3 tools_torch/collective_probe.py [--iters 50]

Needs one CUDA card. Prints the card's name and power limit and one JSON
line a rank: ms a call of a gloo all-reduce of 4 bytes and 128 KB (CPU
tensors), of a gloo barrier, of a sync after a small matmul, of gloo's
all-reduce of a 128 KB and a 16 MB CUDA tensor, of ``psum`` of the same
two CUDA tensors (through the host ring at both sizes: the probe fails if
the tp group has no ring), and of one tp=4 decode step; then the one-card
step's ms.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEP_LAYERS = 4


def _step_inputs(torch, dev, mesh=None):
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving.kv_cache import PagedKVCache

    cfg = llama.LlamaConfig.llama3_8b(n_layers=STEP_LAYERS)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                               mesh=mesh)
    pc = PagedKVCache(cfg, num_pages=512, page_size=16, max_slots=8, max_seq_len=2048,
                      device=dev, mesh=mesh)
    tables = (torch.arange(8 * 64, dtype=torch.int32, device=dev) % 512).reshape(8, 64)
    lens = torch.full((8,), 300, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, 1000, (8,), device=dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)

    def step():
        llama.decode_step_paged(cfg, params, tokens, pc.k_pool, pc.v_pool, tables, lens, active,
                                mesh)
    return step


def probe_rank(dev, iters: int) -> dict:
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.parallel import build_mesh
    from gofr_tpu_torch.parallel.collectives import psum

    from gofr_tpu_torch.parallel.hostring import ring_for

    mesh = build_mesh("tp=4")
    if ring_for(mesh.group("tp")) is None:
        raise RuntimeError("the tp group has no host ring here: psum would time gloo")
    out: dict = {"rank": dist.get_rank()}
    x = torch.randn(8, 4096, device=dev, dtype=torch.bfloat16)
    w = torch.randn(4096, 1024, device=dev, dtype=torch.bfloat16)
    small_cpu, tiny = torch.randn(8, 4096), torch.zeros(1)
    small, big = torch.randn(8, 4096, device=dev), torch.randn(1, 1024, 4096, device=dev)

    def timed(name, body, n=iters):
        for _ in range(3):
            body()
        torch.cuda.synchronize(dev)
        dist.barrier()
        t = time.perf_counter()
        for _ in range(n):
            body()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t) / n * 1e3

    def sync_after_matmul():
        x @ w
        torch.cuda.synchronize(dev)

    timed("gloo all_reduce 4 B cpu ms", lambda: dist.all_reduce(tiny))
    timed("gloo all_reduce 128 KB cpu ms", lambda: dist.all_reduce(small_cpu.clone()))
    timed("gloo barrier ms", dist.barrier)
    timed("sync after a matmul ms", sync_after_matmul)
    timed("gloo all_reduce 128 KB cuda ms", lambda: dist.all_reduce(small.clone()))
    timed("gloo all_reduce 16 MB cuda ms", lambda: dist.all_reduce(big.clone()), 10)
    timed("ring psum 128 KB cuda ms", lambda: psum(small, mesh, "tp"))
    timed("ring psum 16 MB cuda ms", lambda: psum(big, mesh, "tp"), 10)
    timed(f"tp=4 decode step {STEP_LAYERS} layers ms", _step_inputs(torch, dev, mesh), 10)
    return out


def main() -> int:
    import torch

    import tools_torch.collective_probe as me
    from gofr_tpu_torch import _build
    from gofr_tpu_torch.parallel import world

    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.build_all()
    for rank in world.run_spmd(me.probe_rank, 4, args=(args.iters,), backend="gloo",
                               timeout_s=600):
        print(json.dumps(rank))
    step = _step_inputs(torch, torch.device("cuda"))
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    print(json.dumps({f"one card decode step {STEP_LAYERS} layers ms":
                      (time.perf_counter() - t) / 10 * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
