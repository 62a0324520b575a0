"""Run ``chip_smoke.py``'s tp phase alone: the tensor-parallel
``ServingEngine`` over four ranks on the one card over gloo, at Llama-3-8B
widths and full depth (tp=4), TP-B with the bf16 path's config behind an
App over HTTP and gRPC, TP-Q with the int8 path's (chunked prefill) and
TP-W8 with the dense-w8 path's (weight-only int8 params), each held to one
card, TP-R (the prefix cache with its spill tier, ``warm_restart`` and
speculative decoding at ``PLANE_DEPTH`` layers), TP-L (LoRA adapters) and
TP-M (KV migration with a one-card engine: the P/D handoff both ways and
the reclaim evacuation), both at ``PLANE_DEPTH`` layers.

    python3 tools_torch/tp_phase.py

Needs one CUDA card. Builds the kernels and prints the card's name and
power limit. The script takes the one-card tokens from its own bf16, int8
and dense-w8 paths; alone, this first serves the same prompts on a
one-card engine of each config (the same weights from the seed, and
``quantize_params`` of them for dense-w8). Then the phase's own
lines, and last a ``{"tp": ...}`` JSON line.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def one_card_tokens(torch, cs) -> dict:
    """Each main path's tokens by prompt on one card: the traffic
    ``serve_path`` sends, without its checks and timings."""
    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = llama.LlamaConfig.llama3_8b(n_layers=cs.TP_DEPTH)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED),
                               device="cuda")
    gold = {}
    long = cs.MAIN_LENS + [cs.LONG_PROMPT]
    for path, lens in (("bf16", cs.MAIN_LENS), ("int8", long), ("dense-w8", long)):
        t = time.perf_counter()
        if path == "dense-w8":
            params = llama.quantize_params(params)
        engine = ServingEngine(cfg, params, EngineConfig(**cs.MAIN_ENGINES[path]),
                               ByteTokenizer(cfg.vocab_size), seed=cs.SEED)
        engine.start()
        try:
            warm, prompts = cs.main_prompts(cfg.vocab_size, lens)
            gold[path] = [r.token_ids for r in cs.tp_serve(engine, warm, prompts, 32)]
        finally:
            engine.stop()
        print(f"one-card {path} path's tokens in {time.perf_counter() - t:.1f}s", flush=True)
    del engine, params
    torch.cuda.empty_cache()
    return gold


def main() -> int:
    import torch

    import chip_smoke as cs
    from gofr_tpu_torch import _build

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f}s")
    gold = one_card_tokens(torch, cs)
    t = time.perf_counter()
    out = cs.run_phase("tp", cs.run_tp, torch, gold)
    print(f"tp phase alone: {time.perf_counter() - t:.1f}s")
    print(cs.card_line())
    print(json.dumps({"tp": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
