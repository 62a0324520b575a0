"""Standalone cluster worker process for multi-process tests and the
coordination plane on the card (a copy of
``gofr_tpu/distributed/worker_main.py``):

    python -m gofr_tpu_torch.distributed.worker_main \\
        --leader 127.0.0.1:9400 --port 9411 --host-id w1 [--device cuda|cpu]

Boots a tiny Llama ``ServingEngine`` behind the gRPC Inference service,
registers with the leader, and heartbeats until killed: one OS process per
"host". ``--device cpu`` builds the reference's tiny f32 engine (vocab 300,
two slots, 64-token rows). ``--device cuda`` (the default) builds a bf16
tiny config at head dim 64 on a paged cache, since the card's kernels take
bf16 at head dim 64 or 128 (``ops/flash_attention.py``), so its prefills
launch the flash kernel and its decodes the paged one. ``n_devices`` is the
process's card count (1 on the CPU). Each heartbeat's health carries the
kernel launches so far under ``launches``, and on exit it prints them as
``WORKER_LAUNCHES {json}``.
"""

from __future__ import annotations

import asyncio
import json
import signal
import sys


def _parse_args(argv: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    i = 0
    while i < len(argv):
        if argv[i].startswith("--"):
            out[argv[i][2:].replace("-", "_")] = argv[i + 1]
            i += 2
        else:
            i += 1
    return out


def build_engine(device: str) -> tuple:
    """(engine, n_devices) of the worker's tiny model on ``device``."""
    import torch

    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    if device == "cpu":
        cfg = llama.LlamaConfig.tiny(vocab_size=300)
        conf = EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32))
        n_devices = 1
    else:
        cfg = llama.LlamaConfig.tiny(vocab_size=300, d_model=256, n_heads=4, n_kv_heads=2,
                                     d_ff=512, dtype=torch.bfloat16)
        conf = EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32),
                            kv_layout="paged", kv_page_size=16)
        n_devices = torch.cuda.device_count()
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, gen, device=device)
    engine = ServingEngine(cfg, params, conf, ByteTokenizer(), device=device)
    return engine, n_devices


def launch_counts() -> dict[str, int]:
    from gofr_tpu_torch.ops import flash_attention as fa
    from gofr_tpu_torch.ops import paged_attention as pa

    return {"flash_attention": fa.flash_attention.launches,
            "paged_decode_bf16": pa.paged_decode_attention.launches,
            "paged_decode_int8": pa.paged_decode_attention_q.launches}


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    leader = args["leader"]
    port = int(args["port"])
    host_id = args.get("host_id", f"worker-{port}")
    device = args.get("device", "cuda")

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.distributed import WorkerAgent
    from gofr_tpu_torch.grpcx import GRPCServer, InferenceService
    from gofr_tpu_torch.testutil import new_mock_container

    engine, n_devices = build_engine(device)
    engine.start()

    container, _ = new_mock_container()
    server = GRPCServer(container, port, MapConfig({}, use_env=False))
    server.register(InferenceService(engine))

    async def run() -> None:
        await server.start()
        agent = WorkerAgent(
            leader, host_id, f"127.0.0.1:{port}",
            n_devices=n_devices,
            # the heartbeat's health carries the kernel launches so far: a
            # leader still has them after the process is lost
            health_fn=lambda: {**container.health(), "launches": launch_counts()},
            logger=container.logger,
        )
        await agent.start()
        print(f"WORKER_READY {host_id} {port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await agent.stop()
        await server.shutdown(grace=0.2)

    asyncio.run(run())
    engine.stop()
    print(f"WORKER_LAUNCHES {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
