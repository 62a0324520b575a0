"""Run ``chip_smoke.py``'s parallel phase alone: one world of four ranks on
the one card over gloo (``gofr_tpu_torch.parallel``): MP1 tensor parallel
at Llama-3-8B widths, MP2 ring and Ulysses attention and the cp forward,
MP3 expert parallel at Mixtral widths, MP4 the GPipe pipeline, MP5 sharded
and pipelined training, MP6 a sharded restore, each held to the same
computation on one rank.

    python3 tools_torch/parallel_phase.py

Needs one CUDA card. Builds the kernels, prints the card's name and power
limit, the phase's own lines, and last a ``{"parallel": ...}`` JSON line.
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

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    out = cs.run_parallel(torch)
    print(f"parallel phase alone: {time.perf_counter() - t:.1f}s")
    print(cs.card_line())
    print(json.dumps({"parallel": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
