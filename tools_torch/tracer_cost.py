"""What the port's three runtime analyzers cost a decode step: ms a step of
8 greedy rows at Llama-3-8B widths, bare and under each of
``analysis.leaktrace``, ``analysis.deadlinetrace`` and
``analysis.kerneltrace.KernelObserver``, in turns on one engine (bare,
leak, deadline, kernel, kernel, deadline, leak, bare).

    python3 tools_torch/tracer_cost.py [--layers 32] [--rounds 1]

Needs one CUDA card. The engine is the main path's paged bf16 engine
(16-token pages, 4-step blocks) behind a ``Router`` over one
``LocalReplica``, so each request crosses the deadline boundaries
(``Router.submit``, ``LocalReplica.submit``, ``ServingEngine.submit``)
with a deadline. Each turn submits 8 rows of 20-token prompts for 65
tokens; ms a step is the median row's (duration - TTFT) / (tokens - 1),
as ``chip_smoke.py`` takes it. Prints one line a turn, a JSON summary, and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TURNS = ("bare", "leak", "deadline", "kernel", "kernel", "deadline", "leak", "bare")


def measure(torch, cfg, params, rounds: int, device=None) -> dict:
    """The turns on one engine behind a router; ms a step by turn."""
    import chip_smoke as cs
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.analysis import deadlinetrace, leaktrace
    from gofr_tpu_torch.analysis.kerneltrace import KernelObserver
    from gofr_tpu_torch.serving.router import LocalReplica, Router, RouterConfig
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    rng = torch.Generator().manual_seed(cs.SEED + 11)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16, multi_step=4,
        prefill_chunk_tokens=2048), ByteTokenizer(cfg.vocab_size), seed=cs.SEED, device=device)
    router = Router(RouterConfig())
    router.add_replica(LocalReplica("r0", engine))
    engine.start()

    def batch() -> float:
        prompts = [torch.randint(3, cfg.vocab_size, (20,), generator=rng).tolist()
                   for _ in range(8)]
        futs = [router.submit(p, max_new_tokens=65, temperature=0.0, deadline=600.0)
                for p in prompts]
        return cs.per_step_ms([f.result(timeout=600) for f in futs])

    ms: dict[str, list[float]] = {t: [] for t in TURNS}
    try:
        batch()  # warm-up
        for _ in range(rounds):
            for turn in TURNS:
                obs = None
                if turn == "leak":
                    leaktrace.install()
                elif turn == "deadline":
                    deadlinetrace.install()
                elif turn == "kernel":
                    obs = KernelObserver().install()
                try:
                    t0 = time.perf_counter()
                    step = batch()
                    wall = time.perf_counter() - t0
                finally:
                    if turn == "leak":
                        leaktrace.uninstall()
                    elif turn == "deadline":
                        deadlinetrace.uninstall()
                    elif obs is not None:
                        obs.uninstall()
                ms[turn].append(step)
                print(f"{turn:9s} {step:.3f} ms a step ({wall:.2f}s for the batch)", flush=True)
    finally:
        router.stop()
        engine.stop()
    return {t: {"ms_per_step": v, "median": statistics.median(v)} for t, v in ms.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32, help="layers of the 8B-wide model")
    ap.add_argument("--rounds", type=int, default=1, help="times the turn order runs")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gofr_tpu_torch import LlamaConfig, _build
    from gofr_tpu_torch.models.llama import init_params

    _build.build_all()
    cfg = LlamaConfig.llama3_8b(n_layers=args.layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), device="cuda")
    summary = measure(torch, cfg, params, args.rounds)
    card = cs.card_line()
    print(json.dumps({"tracer_cost": summary, "layers": args.layers, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
