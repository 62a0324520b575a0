#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``gofr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``gofr_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with the tolerance stated beside each;
3. serve concurrent requests of mixed prompt lengths through
   ``ServingEngine.submit`` at Llama-3-8B widths (random weights from a
   seeded generator), with the kernels' launch counters reset just before
   and read just after; then serve one greedy request alone and hold the
   logits the engine computed for it (its prefill's and its first decode
   steps', through the paged pool) against a plain dense forward of the
   same weights over the prompt and the tokens the engine generated;
4. time each kernel, its plain version and a PyTorch library call for the
   same function, beside the least time the card could take (its bound),
   and time the engine (TTFT, ms per decode step).

The line before the last is the ``kernels`` record; the last line is the
contract line ``{"ok": true, "device": {...}}``. Without a card, or run
outside a checkout that holds ``gofr_tpu_torch/``, it exits non-zero and
prints no result. Imports nothing of JAX or of ``gofr_tpu``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0  # weights, prompts and kernel inputs all derive from it

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version, per output row (one query head of one token):
# max|got - ref| / max|ref| over the head dim. A one-step bf16 flip of any
# element is at most 2^-7 of the row's largest value; flash adds the
# rounding of P to bf16 against a different running max. 2^-6 is two
# steps, whatever the row's magnitude (late rows of a long prompt are ~30x
# smaller than early ones, so an absolute limit would not see them).
FLASH_ROW_TOL = 2.0 ** -6
PAGED_ROW_TOL = 2.0 ** -6
LOGITS_REL_TOL = 5e-2  # relative L2 of bf16 logits through 32 layers
LOGITS_CHECK_STEPS = 8  # decode steps of the engine held against the dense forward


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call by CUDA events, averaged over ``iters``
    calls after a warm-up, with the 50 MB L2 flushed before each call so
    every input is read from HBM as on the serving path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def row_rel_err(got, want) -> float:
    """Largest per-row error relative to the row's own scale,
    max|got - ref| / max|ref| over the last axis; a row whose reference is
    all zero must be exactly zero (else the error is infinite)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1)
    if bool((err[scale == 0] != 0).any()):
        return math.inf
    return (err[scale > 0] / scale[scale > 0]).max().item()


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------- kernel inputs
def flash_inputs(torch, gen, S: int, kv_lens: list[int], H=32, Hkv=8, D=128):
    B = len(kv_lens)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len


def paged_inputs(torch, gen, seq_lens: list[int], H=32, Hkv=8, Dh=128, page=16):
    """A pool with every sequence's pages scattered at shuffled ids, plus
    spare pages, a trash page, and table tails filled with other ids."""
    B = len(seq_lens)
    M = max(1, max(math.ceil(s / page) for s in seq_lens))
    n_used = sum(math.ceil(s / page) for s in seq_lens)
    N = n_used + 32 + 1
    perm = torch.randperm(N - 1, generator=gen, device="cuda").to(torch.int32)
    tables = torch.empty((B, M), dtype=torch.int32, device="cuda")
    pos = 0
    for b, s in enumerate(seq_lens):
        n = math.ceil(s / page)
        tables[b, :n] = perm[pos:pos + n]
        tables[b, n:] = perm[(pos + n) % (N - 1)]  # unused columns: any id
        pos += n
    k_pool = torch.randn((N, Hkv, page, Dh), generator=gen, device="cuda", dtype=torch.bfloat16)
    v_pool = torch.randn((N, Hkv, page, Dh), generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((B, H, Dh), generator=gen, device="cuda", dtype=torch.bfloat16)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, tables, lens


def check_kernels(torch, gen) -> dict:
    """Each kernel against its plain version; returns, per kernel, its
    largest absolute and per-row relative errors over the cases."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_ref,
    )

    errs = {n: {"max_abs_err": 0.0, "max_row_rel_err": 0.0}
            for n in ("flash_attention", "paged_decode_attention")}
    for S in (32, 128, 1024):
        kv_lens = [S, max(1, S - 7), S // 3 + 1, 0]
        q, k, v, kv_len = flash_inputs(torch, gen, S, kv_lens)
        got = flash_attention(q, k, v, kv_len, causal=True)
        want = flash_attention_ref(q, k, v, kv_len, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        zero_rows = got[3].float().abs().max().item()
        print(f"flash S={S} kv_len={kv_lens}: max_abs_err={err:.3e}, "
              f"max row_rel_err={rel:.3e} (tol {FLASH_ROW_TOL:.3e}), "
              f"kv_len=0 row max |out|={zero_rows}")
        if not (rel <= FLASH_ROW_TOL) or zero_rows != 0.0 or not torch.isfinite(got).all():
            raise AssertionError(f"flash kernel disagrees with its plain version at S={S}")
        e = errs["flash_attention"]
        e["max_abs_err"], e["max_row_rel_err"] = max(e["max_abs_err"], err), max(e["max_row_rel_err"], rel)
    seq_lens = [0, 1, 15, 17, 1000, 333, 64, 999]
    q, kp, vp, tables, lens = paged_inputs(torch, gen, seq_lens)
    got = paged_decode_attention(q, kp, vp, tables, lens)
    want = paged_decode_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    zero_row = got[0].float().abs().max().item()
    print(f"paged seq_lens={seq_lens} page=16: max_abs_err={err:.3e}, "
          f"max row_rel_err={rel:.3e} (tol {PAGED_ROW_TOL:.3e}), seq_len=0 row max |out|={zero_row}")
    if not (rel <= PAGED_ROW_TOL) or zero_row != 0.0 or not torch.isfinite(got).all():
        raise AssertionError("paged kernel disagrees with its plain version")
    errs["paged_decode_attention"] = {"max_abs_err": err, "max_row_rel_err": rel}
    return errs


# ------------------------------------------------------------------ timings
def time_kernels(torch, gen, timer: Timer, errs: dict, launches: dict) -> list[dict]:
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_ref,
    )

    rows = []
    # flash: the main path's largest bucket, one full 1024-token prompt
    S, H, Hkv, D = 1024, 32, 8, 128
    q, k, v, kv_len = flash_inputs(torch, gen, S, [S])
    pairs = S * (S + 1) // 2  # causal (query, key) pairs this input needs
    flops = 4 * H * D * pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4
    b_ms, b_by = bound_ms(flops, nbytes)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "gofr_tpu_torch/csrc/flash_attention.cu",
        "replaces": "gofr_tpu/ops/flash_attention.py:40",
        "launches": launches["flash_attention"],
        **errs["flash_attention"],
        "ms": timer(lambda: flash_attention(q, k, v, kv_len)),
        "plain_ms": timer(lambda: flash_attention_ref(q, k, v, kv_len), iters=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "shape": f"B=1 S={S} H={H} Hkv={Hkv} D={D} kv_len={S} bf16",
    })
    # paged: the main path's decode batch, 8 rows mid-generation
    seq_lens = [21, 47, 76, 136, 266, 496, 793, 1016]
    q, kp, vp, tables, lens = paged_inputs(torch, gen, seq_lens)
    Bp, Hp, Dh = q.shape
    tokens = sum(seq_lens)
    flops = 4 * Hp * Dh * tokens
    nbytes = 2 * 8 * Dh * 2 * tokens + 2 * q.numel() * 2 + tables.numel() * 4 + lens.numel() * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    page, M = kp.shape[2], tables.shape[1]
    valid = torch.arange(M * page, device="cuda")[None, :] < lens[:, None]
    mask = valid[:, None, None, :]  # [B, 1, 1, S]

    def gathered_sdpa():
        kd = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, Dh)
        vd = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, Dh)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kd.repeat_interleave(Hp // 8, dim=1),
            vd.repeat_interleave(Hp // 8, dim=1), attn_mask=mask,
        )

    rows.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "gofr_tpu_torch/csrc/paged_attention.cu",
        "replaces": "gofr_tpu/ops/paged_attention.py:90",
        "launches": launches["paged_decode_attention"],
        **errs["paged_decode_attention"],
        "ms": timer(lambda: paged_decode_attention(q, kp, vp, tables, lens)),
        "plain_ms": timer(lambda: paged_decode_attention_ref(q, kp, vp, tables, lens)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(gathered_sdpa),
        "shape": f"B=8 H=32 Hkv=8 Dh=128 page=16 seq_lens={seq_lens} bf16",
    })
    return rows


# ------------------------------------------------------------------- engine
def dense_logits(torch, cfg, params, ids: list[int], n_last: int):
    """A plain dense forward of the same weights (no kernel, no cache):
    f32 logits [n_last, V] at the last ``n_last`` positions of ``ids``."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.attention import attention
    from gofr_tpu_torch.ops.rope import rope_table

    dev = params["embedding"].device
    tokens = torch.tensor([ids], device=dev)
    S = len(ids)
    x = params["embedding"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=dev)[None]
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    for layer in range(cfg.n_layers):
        lp = llama.layer_params(params, layer)
        _, q, k, v = llama._qkv(cfg, x, lp, sin, cos, positions)
        x = llama._attn_mlp_epilogue(cfg, x, lp, attention(q, k, v, causal=True))
    return llama._logits(cfg, params, x[:, -n_last:])[0]


def check_engine_logits(torch, engine, ids: list[int], steps: int) -> None:
    """Serve one greedy request alone and hold the logits the engine itself
    computed for it against one dense forward over the prompt and the
    tokens the engine generated: the prefill's (bucket-padded, flash
    kernel), then each of its first ``steps`` decode steps' (pages written
    in place through the block tables, the idle rows' writes sent to the
    trash page, state uploaded from pinned memory, the paged kernel)."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops

    cfg, params = engine.model_cfg, engine.params
    prefill_seen, decode_seen = [], []
    prefill_compute, decode_step_paged = batch_ops.prefill_compute, llama.decode_step_paged

    def prefill_hook(*args):
        out = prefill_compute(*args)
        prefill_seen.append(out[0].clone())
        return out

    def step_hook(*args):
        logits, k_pool, v_pool = decode_step_paged(*args)
        decode_seen.append((args[-1].clone(), logits.clone()))  # (live rows, logits)
        return logits, k_pool, v_pool

    batch_ops.prefill_compute, llama.decode_step_paged = prefill_hook, step_hook
    try:
        r = engine.submit(ids, max_new_tokens=steps + 1).result(timeout=600)
    finally:
        batch_ops.prefill_compute, llama.decode_step_paged = prefill_compute, decode_step_paged
    if r.finish_reason != "length" or len(r.token_ids) != steps + 1 or len(prefill_seen) != 1:
        raise AssertionError(f"the logits check request ended {r.finish_reason} after "
                             f"{len(r.token_ids)} tokens")
    live_steps = [(live, lg) for live, lg in decode_seen if bool(live.any())][:steps]
    rows = {tuple(live.nonzero()[:, 0].tolist()) for live, _ in live_steps}
    if len(live_steps) != steps or len(rows) != 1 or len(next(iter(rows))) != 1:
        raise AssertionError(f"expected {steps} decode steps with one live row, saw {rows}")
    (row,) = next(iter(rows))
    got = torch.cat([prefill_seen[0]] + [lg[row:row + 1] for _, lg in live_steps])  # [steps+1, V]
    want = dense_logits(torch, cfg, params, ids + r.token_ids[:steps], steps + 1)
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    picked = got.argmax(-1).tolist() == r.token_ids
    dense_agree = sum(int(a == b) for a, b in zip(want.argmax(-1).tolist(), r.token_ids))
    print(f"  engine logits vs dense forward ({len(ids)}-token prompt, slot {row}): rel_l2 "
          f"prefill {rel[0]:.3e}, decode steps {' '.join(f'{x:.3e}' for x in rel[1:])} "
          f"(tol {LOGITS_REL_TOL}); tokens = argmax of the engine's logits: {picked}; "
          f"dense argmax agrees on {dense_agree}/{steps + 1}")
    if not (max(rel) <= LOGITS_REL_TOL) or not picked or not bool(torch.isfinite(got).all()):
        raise AssertionError("the engine's logits disagree with the dense forward")


def run_engine(torch, launches_out: dict) -> dict:
    from gofr_tpu_torch import EngineConfig, LlamaConfig, ServingEngine
    from gofr_tpu_torch.models.llama import init_params
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + params["embedding"].numel() \
        + params["lm_head"].numel()
    print(f"engine: Llama-3-8B widths, {cfg.n_layers} layers, {n_params / 1e9:.2f}B params "
          f"bf16, random init in {time.perf_counter() - t0:.1f}s")
    ecfg = EngineConfig(max_slots=8, max_seq_len=2048, kv_page_size=16, multi_step=4,
                        max_new_tokens_default=32)
    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED)
    rng = torch.Generator().manual_seed(SEED)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    engine.start()
    try:
        engine.submit(prompt(5), max_new_tokens=4).result(timeout=600)  # warm-up
        # ---- the main path: counters from 0, read right after
        lens = [5, 31, 60, 120, 250, 480, 777, 1000, 9, 333]
        prompts = [prompt(n) for n in lens]
        flash_attention.launches = 0
        paged_decode_attention.launches = 0
        futs = [
            engine.submit(p, max_new_tokens=32,
                          **(dict(temperature=0.8, top_k=50, top_p=0.95) if i == 3 else {}))
            for i, p in enumerate(prompts)
        ]
        results = [f.result(timeout=900) for f in futs]
        launches_out["flash_attention"] = flash_attention.launches
        launches_out["paged_decode_attention"] = paged_decode_attention.launches
        for n, r in zip(lens, results):
            print(f"  prompt {n:4d} -> {r.completion_tokens:2d} tokens, {r.finish_reason}, "
                  f"ttft {r.ttft_s * 1e3:.1f} ms")
            if r.finish_reason not in ("length", "stop") or r.prompt_tokens != n:
                raise AssertionError(f"request with a {n}-token prompt ended {r.finish_reason}")
            if r.finish_reason == "length" and r.completion_tokens != 32:
                raise AssertionError("a length finish must carry 32 tokens")
            if any(not (0 <= t < cfg.vocab_size) for t in r.token_ids):
                raise AssertionError("token id outside the vocabulary")
        print(f"  launches on the main path: {launches_out}")
        if not all(launches_out.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches_out}")

        # ---- the engine's own prefill and decode logits vs a plain dense
        # forward; 45 tokens: decode crosses a page boundary at position 48
        check_engine_logits(torch, engine, prompt(45), LOGITS_CHECK_STEPS)

        # ---- engine timings: TTFT alone at each bucket, then a full batch
        ttft = {}
        for n in (100, 1000):
            r = engine.submit(prompt(n), max_new_tokens=2).result(timeout=600)
            ttft[f"ttft_ms_prompt{n}_alone"] = r.ttft_s * 1e3
        batch = [engine.submit(prompt(20), max_new_tokens=65) for _ in range(8)]
        res = [f.result(timeout=900) for f in batch]
        per_step = sorted((r.duration_s - r.ttft_s) / (r.completion_tokens - 1) * 1e3 for r in res
                          if r.completion_tokens > 1)
        timings = dict(ttft, decode_ms_per_step_batch8=per_step[len(per_step) // 2] if per_step else None,
                       main_path_ttft_ms_max=max(r.ttft_s for r in results) * 1e3)
        return timings
    finally:
        engine.stop()


def main() -> int:
    if not (ROOT / "gofr_tpu_torch" / "_build.py").is_file():
        return fail(f"no gofr_tpu_torch package beside {Path(__file__).name}: run it from a checkout")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from gofr_tpu_torch import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s ({_build.BUILD_DIR})")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = check_kernels(torch, gen)

    launches = {"flash_attention": 0, "paged_decode_attention": 0}
    engine_timings = run_engine(torch, launches)
    torch.cuda.empty_cache()
    rows = time_kernels(torch, gen, Timer(torch), errs, launches)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}")
    print(json.dumps({"engine": engine_timings}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
