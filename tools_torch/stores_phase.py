"""Run ``chip_smoke.py``'s stores phase alone: generation jobs claimed,
logged, metered and indexed through the port's KV, document, wide-column and
search datasources (ST1 on their wire clients and fakes, ST2 the card's
memory sampled into the time-series store, ST3 the embedded stores), on
Llama-3-8B weights made from the script's seed at full depth.

    python3 tools_torch/stores_phase.py

Needs one CUDA card. Builds the kernels, prints the card's name and power
limit, the phase's own lines, and last a ``{"stores": ...}`` JSON line.
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
    out = cs.run_stores(torch, cfg, params)
    print(cs.card_line())
    print(json.dumps({"stores": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
