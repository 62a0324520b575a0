"""Run ``chip_smoke.py``'s F2 (a reclamation notice on a preemptible
Llama-3-8B replica beside a survivor) alone, several times, each beside
a number of Python threads that hold the GIL half of the time, as a busy
shared host would.

    python3 tools_torch/f2_reclaim_probe.py --notice 5,30 --threads 0,1

Needs one CUDA card. Prints one line per run: the notice, the competing
threads, and F2's verdict with its reclamation timings (the batch rows'
settling and each interactive row's last frame, in seconds after the
notice), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def busy(stop: threading.Event) -> None:
    """Hold the GIL 5 ms, sleep 5 ms, until stopped."""
    while not stop.is_set():
        t = time.perf_counter()
        while time.perf_counter() - t < 0.005:
            pass
        time.sleep(0.005)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--notice", default="30", help="comma-separated notices, seconds")
    ap.add_argument("--threads", default="0,1", help="comma-separated competing thread counts")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gofr_tpu_torch import LlamaConfig, _build
    from gofr_tpu_torch.models.llama import init_params

    _build.build_all()
    cfg = LlamaConfig.llama3_8b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), device="cuda")
    rng = torch.Generator().manual_seed(cs.SEED + 7)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    failed = 0
    for notice in (float(x) for x in args.notice.split(",")):
        for n in (int(x) for x in args.threads.split(",")):
            cs.FLEET_NOTICE_S = notice
            stop = threading.Event()
            threads = [threading.Thread(target=busy, args=(stop,), daemon=True)
                       for _ in range(n)]
            for t in threads:
                t.start()
            try:
                r = cs.fleet_f2(torch, cfg, params, prompt, {})["reclaim"]
                verdict = "ok"
            except AssertionError as exc:
                r, verdict = str(exc), "FAIL"
                failed += 1
            finally:
                stop.set()
                for t in threads:
                    t.join()
            if isinstance(r, dict):
                r = {k: r[k] for k in ("summary", "notice_to_committed_s", "frames_at_notice",
                                       "bulk_settled_s", "gold_last_frame_s")}
            print(f"F2 notice={notice:g}s threads={n} {verdict} {r}", flush=True)
            torch.cuda.empty_cache()
    print(cs.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
