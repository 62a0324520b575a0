"""Run ``chip_smoke.py``'s grpc phase alone: streaming decode and the
request lifecycle over the port's own gRPC wire on a paged bf16 engine (G1,
G2), Google Pub/Sub jobs on the port's fake over a paged int8 engine (G3),
and the coordination plane with two worker processes on the card (G4), on
Llama-3-8B weights made from the script's seed at ``PLANE_DEPTH`` layers.

    python3 tools_torch/grpc_phase.py

Needs one CUDA card. Builds the kernels, prints the card's name and power
limit, the phase's own lines, and last a ``{"grpc": ...}`` JSON line.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from gofr_tpu_torch import _build
    from gofr_tpu_torch.models.llama import LlamaConfig, init_params

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f}s")
    cfg = LlamaConfig.llama3_8b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), device="cuda")
    t = time.perf_counter()
    out = cs.run_grpc(torch, *cs.cut_depth(cfg, params, cs.PLANE_DEPTH))
    print(f"grpc phase alone: {time.perf_counter() - t:.1f}s")
    print(cs.card_line())
    print(json.dumps({"grpc": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
