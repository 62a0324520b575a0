"""Run ``chip_smoke.py``'s parallel phase alone: one world of four ranks on
the one card over gloo (``gofr_tpu_torch.parallel``): MP1 tensor parallel
at Llama-3-8B widths, MP2 ring and Ulysses attention and the cp forward,
MP3 expert parallel at Mixtral widths, MP4 the GPipe pipeline, MP5 sharded
and pipelined training, MP6 a sharded restore, each held to the same
computation on one rank, and MP7 the device client over dp=4 through the
sick-chip failover.

    python3 tools_torch/parallel_phase.py [--only mp7]

Needs one CUDA card. Builds the kernels, prints the card's name and power
limit, the phase's own lines, and last a ``{"parallel": ...}`` JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description="chip_smoke.py's parallel phase alone")
    parser.add_argument("--only", choices=("mp7",), default=None,
                        help="run one step of the phase alone")
    args = parser.parse_args()
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
    out = cs.run_parallel(torch, only=args.only)
    print(f"parallel phase alone: {time.perf_counter() - t:.1f}s")
    print(cs.card_line())
    print(json.dumps({"parallel": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
