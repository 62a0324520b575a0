"""Run ``chip_smoke.py``'s files phase alone: weights through the port's file
systems (F-S1) and generation jobs from files with a Redis result cache
(F-S2), on Llama-3-8B weights made from the script's seed.

    python3 tools_torch/files_phase.py

Needs one CUDA card. Builds the kernels, prints the card's name and power
limit, the ``cryptography`` version (or that it is missing: the SFTP legs
then do not run), the phase's own lines, and last a ``{"files": ...}``
JSON line.
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; cryptography "
          f"{cs.has_cryptography() or 'not installed'}")
    t = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f}s")
    cfg = LlamaConfig.llama3_8b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), device="cuda")
    out = cs.run_files(torch, cfg, params, LlamaConfig.llama3_8b(n_layers=cs.FILES_S1_DEPTH))
    print(cs.card_line())
    print(json.dumps({"files": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
