#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``gofr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each a hard failure with a non-zero exit:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``gofr_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel), with ptxas's report (registers, spills, shared memory) of
   the main path's instantiations beside it; a report that wgmma was
   serialized fails the phase;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and where the kernels can break, with the tolerance
   stated beside each: flash at buckets on and off its 128-row query and
   64-key tiles (S 32…2048), head dims 64 and 128, causal and not, kv_len
   0, odd and off every tile edge; both paged kernels at pages 16 and 32
   with lengths 0, on and one past a split span, a lone 4000-token row
   (B=1), and groups of 4 and 8 query heads;
3. drive four engine paths through ``ServingEngine.submit`` at Llama-3-8B
   widths (random weights from a seeded generator), each with the
   kernels' launch counters reset just before and read just after:
   - ``bf16``: bf16 paged KV, every prompt prefilled whole (flash kernel),
     decode through the bf16 paged kernel;
   - ``int8``: int8 paged KV on 32-token pages with the reference's
     256-token prefill chunks, prompts up to 3000 tokens (past the
     largest bucket): short prompts prefill whole, long ones chunk through
     the unified ragged dispatch, decode through the int8 paged kernel;
   - ``dense``: the reference's defaults, the dense slot cache with bf16
     KV and 256-token chunks: prompts of at most 256 tokens prefill whole
     (flash), longer ones chunk through the dense ragged dispatch, decode
     reads each row's whole layer cache in plain PyTorch (as the
     reference's XLA does); neither paged kernel may launch;
   - ``dense-w8``: the dense cache with int8 KV and weight-only int8
     params (``quantize_params`` of the same weights, on the card), prompts
     up to 3000 tokens;
   then serve one greedy request alone on each path and hold the logits
   the engine computed for it (its prefill's or final chunk's, and its
   decode steps', through the pool or the slot cache) against a plain
   dense forward of the same weights over the prompt and the tokens the
   engine generated (on the int8 paths with K/V passed through
   ``quantize_kv`` and ``dequantize_kv`` at every layer);
4. time each kernel, its plain version and a PyTorch library call for the
   same function, beside the least time the card could take (its bound),
   at the main path's shapes; then, for information, flash at S=2048 and
   each paged kernel on the lone 4000-token row, each beside its bound,
   and each paged wrapper's host time per call; the wall and kernel time
   of one decode block of each layout (bf16 and int8 weights on the dense
   cache); and time each engine path (TTFT, ms per decode step).

The line before the last is the ``kernels`` record; the last line is the
contract line ``{"ok": true, "device": {...}}``. Without a card, or run
outside a checkout that holds ``gofr_tpu_torch/``, it exits non-zero and
prints no result. Imports nothing of JAX or of ``gofr_tpu``.
"""

from __future__ import annotations

import asyncio
import json
import math
import re
import subprocess
import sys
import threading
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
# smaller than early ones, so an absolute limit would not see them). The
# int8 kernel and its plain version dequantize the same int8 values with
# the same scales in f32, so only the output's rounding differs.
FLASH_ROW_TOL = 2.0 ** -6
PAGED_ROW_TOL = 2.0 ** -6
LOGITS_REL_TOL = 5e-2  # relative L2 of bf16 logits through 32 layers
PAGED_CHECK_LENS = [0, 1, 15, 17, 1000, 333, 64, 999]  # kernel check lengths
# lengths ending exactly on a split span of the paged kernels (256 tokens)
# and one past it, besides the edges above
SPAN_CHECK_LENS = [0, 1, 17, 256, 257, 512, 513, 999]
LONE_ROW = 4000  # one long request alone (B=1): split across 16 spans
FLASH_CHECK_S = (32, 128, 200, 1024, 2048)
MAIN_LENS = [5, 31, 60, 120, 250, 480, 777, 1000, 9, 333]  # the bf16 path's prompts
LONG_PROMPT = 3000  # the int8 path's extra prompt, past the largest bucket (2048)


# the main path's kernel instantiations, as ptxas names them (mangled):
# flash at D=128; the paged template at Dh=128, G=4 over bf16 (t) and int8 (a)
PATH_INSTANCES = {
    "flash_attention": {"flash D=128": "flash_fwd_kernelILi128EE"},
    "paged_attention": {"paged bf16 Dh=128 G=4": "paged_decode_kernelILi128ELi4EtEE",
                        "paged int8 Dh=128 G=4": "paged_decode_kernelILi128ELi4EaEE"},
}


def start_ptxas(build) -> dict:
    """Start one ``nvcc -Xptxas -v -c`` per source (with the build's own
    flags), beside the build; ``ptxas_report`` collects them."""
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return {name: subprocess.Popen(
        [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(build.BUILD_DIR / f"{name}.ptxas.o"),
         str(build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in PATH_INSTANCES}


def ptxas_report(jobs: dict) -> dict:
    """Registers, spills and static shared memory of each main-path kernel
    instantiation, from ptxas's report; any note that wgmma was serialized
    fails the run's build phase."""
    report = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for csrc/{name}.cu:\n{out}")
        current, stats = None, {}
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)", line)
            if m:
                current = m.group(1)
            elif current and "spill stores" in line:
                n = re.findall(r"(\d+) bytes", line)
                stats.setdefault(current, {}).update(stack=int(n[0]), spill_stores=int(n[1]),
                                                    spill_loads=int(n[2]))
            elif current and "Used" in line and "registers" in line:
                stats.setdefault(current, {}).update(
                    registers=int(re.search(r"Used (\d+) registers", line).group(1)),
                    static_smem=int(re.search(r"(\d+) bytes smem", line).group(1)))
            if "wgmma.mma_async instructions are serialized" in line:
                raise RuntimeError(f"csrc/{name}.cu: {line.strip()}")
        for label, key in PATH_INSTANCES[name].items():
            found = [v for k, v in stats.items() if key in k]
            if len(found) != 1:
                raise RuntimeError(f"ptxas report of csrc/{name}.cu has no single {key}")
            report[label] = found[0]
            print(f"ptxas {label}: {found[0]}")
    return report


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
    every input is read from HBM as on the serving path. After the flush
    the card sleeps about a millisecond (``torch.cuda._sleep``), so the
    host has queued the call before its start event runs: the time is the
    device's, not the host's launch overhead (a wrapper's checks and
    allocations can take longer than the flush alone)."""

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
            torch.cuda._sleep(2_000_000)
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


def counters() -> dict:
    """Each kernel wrapper of the port by name; ``.launches`` is its count."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

    return {"flash_attention": flash_attention, "paged_decode_attention": paged_decode_attention,
            "paged_decode_attention_q": paged_decode_attention_q}


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


def paged_inputs_q(torch, gen, seq_lens: list[int], page: int, **shape):
    """``paged_inputs`` with the pools quantized per vector as the engine
    stores them: (q, k_pool, v_pool int8, k_scale, v_scale, tables, lens)."""
    from gofr_tpu_torch.models.llama import quantize_kv

    q, kp, vp, tables, lens = paged_inputs(torch, gen, seq_lens, page=page, **shape)
    kq, ks = quantize_kv(kp * 3)  # scales far from 1: a wrong scale shows
    vq, vs = quantize_kv(vp)
    return q, kq, vq, ks[..., None].contiguous(), vs[..., None].contiguous(), tables, lens


def check_kernels(torch, gen) -> dict:
    """Each kernel against its plain version; returns, per kernel, its
    largest absolute and per-row relative errors over the cases."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_q,
        paged_decode_attention_ref,
    )

    errs = {n: {"max_abs_err": 0.0, "max_row_rel_err": 0.0} for n in counters()}

    def record(name, got, want, zero_row, tol, what):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        print(f"{what}: max_abs_err={err:.3e}, max row_rel_err={rel:.3e} (tol {tol:.3e}), "
              f"empty row max |out|={zero_row}")
        if not (rel <= tol) or zero_row != 0.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: the kernel disagrees with its plain version")
        e = errs[name]
        e["max_abs_err"], e["max_row_rel_err"] = max(e["max_abs_err"], err), max(e["max_row_rel_err"], rel)

    for S in FLASH_CHECK_S:
        # kv_len full, odd (S - 7), off every tile edge (S // 3 + 1), and 0;
        # H=8 at 2048 keeps the dense plain version small
        kv_lens = [S, max(1, S - 7), S // 3 + 1, 0]
        H, Hkv = (32, 8) if S <= 1024 else (8, 2)
        for D in (64, 128):
            for causal in (True, False):
                q, k, v, kv_len = flash_inputs(torch, gen, S, kv_lens, H=H, Hkv=Hkv, D=D)
                got = flash_attention(q, k, v, kv_len, causal=causal)
                want = flash_attention_ref(q, k, v, kv_len, causal=causal)
                record("flash_attention", got, want, got[3].float().abs().max().item(),
                       FLASH_ROW_TOL, f"flash S={S} H={H} Hkv={Hkv} D={D} causal={int(causal)} "
                       f"kv_len={kv_lens}")
    # (lengths, H, Hkv, Dh): G = 4 at the model's widths, G = 8 at Dh 64
    paged_cases = [(PAGED_CHECK_LENS, 32, 8, 128), (SPAN_CHECK_LENS, 32, 8, 128),
                   ([LONE_ROW], 32, 8, 128), (SPAN_CHECK_LENS, 16, 2, 64)]
    for page in (16, 32):
        for lens_, H, Hkv, Dh in paged_cases:
            shape = dict(H=H, Hkv=Hkv, Dh=Dh)
            empty = lens_.index(0) if 0 in lens_ else None
            what = f"seq_lens={lens_ if len(lens_) > 1 else lens_[0]} H={H} Hkv={Hkv} Dh={Dh} page={page}"
            q, kp, vp, tables, lens = paged_inputs(torch, gen, lens_, page=page, **shape)
            got = paged_decode_attention(q, kp, vp, tables, lens)
            want = paged_decode_attention_ref(q, kp, vp, tables, lens)
            record("paged_decode_attention", got, want,
                   0.0 if empty is None else got[empty].float().abs().max().item(), PAGED_ROW_TOL,
                   f"paged bf16 {what}")
            q, kq, vq, ks, vs, tables, lens = paged_inputs_q(torch, gen, lens_, page, **shape)
            got = paged_decode_attention_q(q, kq, vq, ks, vs, tables, lens)
            want = paged_decode_attention_ref(q, kq, vq, tables, lens, k_scale=ks, v_scale=vs)
            record("paged_decode_attention_q", got, want,
                   0.0 if empty is None else got[empty].float().abs().max().item(), PAGED_ROW_TOL,
                   f"paged int8 {what}")
    return errs


# ------------------------------------------------------------------ timings
DECODE_LENS = [21, 47, 76, 136, 266, 496, 793, 1016]  # the decode batch mid-generation


def time_kernels(torch, gen, timer: Timer, errs: dict, launches: dict) -> list[dict]:
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from gofr_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_q,
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
        "launches": launches["bf16"]["flash_attention"],
        **errs["flash_attention"],
        "ms": timer(lambda: flash_attention(q, k, v, kv_len)),
        "plain_ms": timer(lambda: flash_attention_ref(q, k, v, kv_len), iters=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "shape": f"B=1 S={S} H={H} Hkv={Hkv} D={D} kv_len={S} bf16",
        "launches_by_path": {p: c["flash_attention"] for p, c in launches.items()},
    })

    # paged, bf16 and int8: the main path's decode batch, 8 rows mid-generation
    tokens = sum(DECODE_LENS)

    def paged_row(name, source, page, kv_bytes, quantized):
        if quantized:
            q, kp, vp, ks, vs, tables, lens = paged_inputs_q(torch, gen, DECODE_LENS, page)
            args, kw = (q, kp, vp, ks, vs, tables, lens), {"k_scale": ks, "v_scale": vs}
            kernel, plain_args = paged_decode_attention_q, (q, kp, vp, tables, lens)
        else:
            q, kp, vp, tables, lens = paged_inputs(torch, gen, DECODE_LENS, page=page)
            args = plain_args = (q, kp, vp, tables, lens)
            kw, kernel = {}, paged_decode_attention
        Bp, Hp, Dh = q.shape
        flops = 4 * Hp * Dh * tokens
        nbytes = 2 * 8 * kv_bytes * tokens + 2 * q.numel() * 2 + tables.numel() * 4 + lens.numel() * 4
        b_ms, b_by = bound_ms(flops, nbytes)
        M = tables.shape[1]
        mask = (torch.arange(M * page, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

        def gathered_sdpa():
            t = tables.long()
            kd = kp[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, Dh)
            vd = vp[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, Dh)
            if quantized:
                kd = (kd.float() * ks[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, 1)).to(q.dtype)
                vd = (vd.float() * vs[t].permute(0, 2, 1, 3, 4).reshape(Bp, 8, M * page, 1)).to(q.dtype)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], kd.repeat_interleave(Hp // 8, dim=1),
                vd.repeat_interleave(Hp // 8, dim=1), attn_mask=mask,
            )

        path = "int8" if quantized else "bf16"
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": "gofr_tpu/ops/paged_attention.py:90",
            "launches": launches[path][name],
            **errs[name],
            "ms": timer(lambda: kernel(*args)),
            "plain_ms": timer(lambda: paged_decode_attention_ref(*plain_args, **kw)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(gathered_sdpa),
            "shape": f"B=8 H=32 Hkv=8 Dh=128 page={page} seq_lens={DECODE_LENS} "
                     + ("int8 pools + f32 scales" if quantized else "bf16"),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
        }

    rows.append(paged_row("paged_decode_attention", "gofr_tpu_torch/csrc/paged_attention.cu",
                          16, 128 * 2, quantized=False))
    rows.append(paged_row("paged_decode_attention_q", "gofr_tpu_torch/csrc/paged_attention.cu",
                          32, 128 + 4, quantized=True))
    return rows


def wrapper_host_us(torch, gen, calls: int = 200) -> dict:
    """Host time of one call of each paged wrapper (its checks, buffers and
    launch), in microseconds: the median over 5 rounds of ``calls`` calls
    at the main path's decode batch, with no synchronize between calls.
    It calls only the wrappers' public signatures, so it can time another
    checkout's package too (import that package first)."""
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

    out = {}
    for name, fn, args in (
        ("paged_decode_attention", paged_decode_attention, paged_inputs(torch, gen, DECODE_LENS, page=16)),
        ("paged_decode_attention_q", paged_decode_attention_q, paged_inputs_q(torch, gen, DECODE_LENS, 32)),
    ):
        fn(*args)
        torch.cuda.synchronize()
        rounds = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            rounds.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[name] = sorted(rounds)[2]
    print("(information) paged wrapper host us per call: "
          + ", ".join(f"{n} {us:.2f}" for n, us in out.items()))
    return out


def time_information(torch, gen, timer: Timer) -> dict:
    """Kernel times outside the main path's shapes, each beside its bound,
    for information: flash on the largest bucket (S=2048) against
    ``scaled_dot_product_attention``, and each paged kernel on one
    4000-token row alone (B=1, split across blocks)."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import flash_attention
    from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q

    info = {}
    S, H, Hkv, D = 2048, 32, 8, 128
    q, k, v, kv_len = flash_inputs(torch, gen, S, [S])
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    b_ms, b_by = bound_ms(4 * H * D * S * (S + 1) // 2, 2 * (2 * q.numel() + k.numel() + v.numel()))
    info["flash_attention_S2048"] = {
        "ms": timer(lambda: flash_attention(q, k, v, kv_len)), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "shape": f"B=1 S={S} H={H} Hkv={Hkv} D={D} causal bf16"}
    del q, k, v, qt, kt, vt
    for name, page, kv_bytes in (("paged_decode_attention", 16, 128 * 2),
                                 ("paged_decode_attention_q", 32, 128 + 4)):
        if name.endswith("_q"):
            args = paged_inputs_q(torch, gen, [LONE_ROW], page)
            fn = paged_decode_attention_q
        else:
            args = paged_inputs(torch, gen, [LONE_ROW], page=page)
            fn = paged_decode_attention
        b_ms, b_by = bound_ms(4 * 32 * 128 * LONE_ROW, 2 * 8 * kv_bytes * LONE_ROW + 2 * 2 * 32 * 128)
        info[f"{name}_lone{LONE_ROW}"] = {
            "ms": timer(lambda: fn(*args)), "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B=1 H=32 Hkv=8 Dh=128 page={page} seq_len={LONE_ROW}"}
    for n, r in info.items():
        lib = f", library {r['library_ms']:.4f}" if "library_ms" in r else ""
        print(f"(information) {n}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}"
              f"{lib}) at {r['shape']}")
    info["paged_wrapper_host_us"] = wrapper_host_us(torch, gen)
    return info


def kernel_label(key: str) -> str:
    """A profiler kernel name cut short: its head (up to 48 characters)
    and, for PyTorch's templated elementwise kernels, whose heads all look
    alike, the operation inside (``direct_copy_kernel_cuda``, a
    ``...Functor``)."""
    name = key.replace("void ", "").replace("(anonymous namespace)::", "")
    head = name.split("(")[0].split("<")[0][:48]
    ops = re.findall(r"(\w+_kernel_cuda|\w+Functor)\b", key)
    return f"{head} {ops[-1]}" if ops else head


def dispatch_busy(torch, cfg, params, params_w8) -> dict:
    """Where a dispatch's time goes: host wall time of one call of the
    engine's device functions, synchronized (median of 5), against the sum
    of the kernel times ``torch.profiler`` records for one more call. The
    rest of the wall time the card sits idle, waiting for the host to
    issue work. Cases: the N-step decode block at batch 8 (512 tokens of
    context a row) over bf16 and int8 pools, and a ragged dispatch that
    runs one 256-token chunk alone (the fourth chunk of a 1000-token
    prompt, as the int8 path's TTFT runs it); then the dense decode block
    at the same batch and context over the dense paths' caches: bf16 KV
    at 2048 positions with bf16 and with int8 weights (their difference is
    what the weights' eager int8-to-bf16 copies cost), and int8 KV at 4096
    positions with int8 weights."""
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.serving import batch as batch_ops
    from gofr_tpu_torch.serving.kv_cache import PagedKVCache

    B, N, ctx, C = 8, 4, 512, 256
    dev = params["embedding"].device
    out = {}

    def measure(name, call):
        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
        wall = sorted(walls)[2]
        by_label: dict = {}
        for e in events:
            label = kernel_label(e.key)
            by_label[label] = by_label.get(label, 0.0) + e.self_device_time_total / 1e3
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"wall_ms": wall, "kernel_ms": kernel_ms or None,
                     "device_busy_share": kernel_ms / wall if kernel_ms else None,
                     "top_kernels_ms": dict(top)}
        print(f"  {name}: wall {wall:.2f} ms, kernels {kernel_ms:.2f} ms "
              f"(busy share {kernel_ms / wall:.3f}); top: "
              + ", ".join(f"{k} {v:.2f}" for k, v in out[name]["top_kernels_ms"].items()))

    def state(lens):
        return batch_ops.make_decode_state(
            [7] * B, lens, [False] * B, [10_000] * B, [-1] * B, [0.0] * B, [0] * B,
            [1.0] * B, torch.Generator(device=dev).manual_seed(SEED), device=dev)

    active = torch.ones(B, dtype=torch.bool, device=dev)
    for kv_dtype, page in (("bf16", 16), ("int8", 32)):
        cap = 4 * C + 64  # pages for a 1000-token prompt's fourth chunk, and decode room
        pc = PagedKVCache(cfg, num_pages=B * cap // page, page_size=page, max_slots=B,
                          max_seq_len=cap, device=dev, kv_dtype=kv_dtype)
        for b in range(B):
            pc.alloc_slot(b, seq_id=b, prompt_len=ctx, reserve_tokens=cap)
        tables = pc.tables_device()
        fn = batch_ops.decode_block_paged_q if pc.quantized else batch_ops.decode_block_paged
        pools = pc.pools() if pc.quantized else pc.pools()[:2]
        measure(f"decode_block_{kv_dtype}_b8_n4",
                lambda: fn(cfg, params, *pools, state([ctx] * B), tables, active, N)[0].cpu())
        if pc.quantized:
            chunk = torch.randint(3, cfg.vocab_size, (B, C), device=dev)
            i32 = dict(dtype=torch.int32, device=dev)
            zeros = torch.zeros(B, **i32)
            measure("ragged_int8_one_256_chunk", lambda: batch_ops.ragged_step_paged_q(
                cfg, params, *pools, state([1] * B), tables, chunk,
                torch.full((B,), 3 * C, **i32), torch.tensor([0], device=dev),
                torch.full((B,), cap, **i32), torch.zeros(B, dtype=torch.bool, device=dev),
                torch.full((B,), 4 * C, **i32), zeros, torch.full((B,), -1, device=dev),
                torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int64, device=dev),
                torch.ones(B, device=dev), [SEED], torch.zeros(B, dtype=torch.bool, device=dev), 0,
            )[0].cpu())
        del pc, pools
    from gofr_tpu_torch.models.llama import KVCache

    for kv_dtype, S, weights, tree in ((None, 2048, "bf16", params), (None, 2048, "int8", params_w8),
                                       ("int8", 4096, "int8", params_w8)):
        cache = KVCache.create(cfg, B, max_len=S, kv_dtype=kv_dtype, device=dev)
        measure(f"dense_block_{kv_dtype or 'bf16'}_kv{S}_{weights}_weights_b8_n4",
                lambda: batch_ops.decode_block(cfg, tree, cache, state([ctx] * B), active, N)[0].cpu())
        del cache
    return out


# ------------------------------------------------------------------- engine
def dense_logits(torch, cfg, params, ids: list[int], n_last: int, kv_quant: bool):
    """A plain dense forward of the same weights (no kernel, no cache):
    f32 logits [n_last, V] at the last ``n_last`` positions of ``ids``.
    With ``kv_quant`` every layer's K/V pass through ``quantize_kv`` and
    ``dequantize_kv`` first, as everything the int8 engine reads does."""
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
        if kv_quant:
            k = llama.dequantize_kv(*llama.quantize_kv(k), cfg.dtype)
            v = llama.dequantize_kv(*llama.quantize_kv(v), cfg.dtype)
        x = llama._attn_mlp_epilogue(cfg, x, lp, attention(q, k, v, causal=True))
    return llama._logits(cfg, params, x[:, -n_last:])[0]


def ragged_name(engine) -> str:
    """The ragged dispatch function the engine's layout and KV dtype run."""
    if engine.paged_cache is None:
        return "ragged_step"
    return "ragged_step_paged_q" if engine.paged_cache.quantized else "ragged_step_paged"


def check_engine_logits(torch, engine, ids: list[int], steps: int) -> None:
    """Serve one greedy request alone and hold the logits the engine itself
    computed for it against one dense forward over the prompt and the
    tokens the engine generated: the prefill's (a prompt of at most one
    chunk: one bucketed flash prefill) or the final chunk's (a longer one:
    chunks through the ragged dispatch, the first token folded on the
    device), then each of its first ``steps`` decode steps' (K/V written in
    place into the slot row, the frozen rows' writes sent to the sink past
    the dense cache's end; or through the block tables, the idle rows'
    writes sent to the trash page, the paged kernel)."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops

    cfg, params = engine.model_cfg, engine.params
    dense = engine.paged_cache is None
    quantized = (engine.cache if dense else engine.paged_cache).quantized
    chunked = engine._route_chunked(len(ids))
    # (function whose logits are the prompt's, index of those logits in its
    # result), and the decode step's function name
    pre_name, pre_idx = (ragged_name(engine), 1) if chunked else ("prefill_compute", 0)
    step_name = "decode_step" if dense else ("decode_step_paged_q" if quantized else "decode_step_paged")
    prefill_seen, decode_seen = [], []
    prefill_fn, step_fn = getattr(batch_ops, pre_name), getattr(llama, step_name)

    def prefill_hook(*args):
        out = prefill_fn(*args)
        prefill_seen.append(out[pre_idx].clone())
        return out

    def step_hook(*args):
        out = step_fn(*args)
        # a dense step's frozen rows run at length S_max + 1; a paged step
        # takes its live rows as its last argument
        live = args[4] <= args[3].max_len if dense else args[-1]
        decode_seen.append((live.clone(), out[0].clone()))  # (live rows, logits)
        return out

    setattr(batch_ops, pre_name, prefill_hook)
    setattr(llama, step_name, step_hook)
    try:
        r = engine.submit(ids, max_new_tokens=steps + 1).result(timeout=600)
    finally:
        setattr(batch_ops, pre_name, prefill_fn)
        setattr(llama, step_name, step_fn)
    n_prefill = math.ceil(len(ids) / engine._chunk_tokens) if chunked else 1
    if r.finish_reason != "length" or len(r.token_ids) != steps + 1 or len(prefill_seen) != n_prefill:
        raise AssertionError(f"the logits check request ended {r.finish_reason} after "
                             f"{len(r.token_ids)} tokens and {len(prefill_seen)} prefill calls")
    live_steps = [(live, lg) for live, lg in decode_seen if bool(live.any())][:steps]
    rows = {tuple(live.nonzero()[:, 0].tolist()) for live, _ in live_steps}
    if len(live_steps) != steps or len(rows) != 1 or len(next(iter(rows))) != 1:
        raise AssertionError(f"expected {steps} decode steps with one live row, saw {rows}")
    (row,) = next(iter(rows))
    got = torch.cat([prefill_seen[-1][-1:]] + [lg[row:row + 1] for _, lg in live_steps])  # [steps+1, V]
    seq = ids + r.token_ids[:steps]
    want = dense_logits(torch, cfg, params, seq, steps + 1, kv_quant=quantized)
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    picked = got.argmax(-1).tolist() == r.token_ids
    dense_agree = sum(int(a == b) for a, b in zip(want.argmax(-1).tolist(), r.token_ids))
    what = "final chunk" if chunked else "prefill"
    print(f"  engine logits vs dense forward{' (K/V quantized)' if quantized else ''} "
          f"({len(ids)}-token prompt, {n_prefill} prefill call(s), slot {row}): rel_l2 "
          f"{what} {rel[0]:.3e}, decode steps {' '.join(f'{x:.3e}' for x in rel[1:])} "
          f"(tol {LOGITS_REL_TOL}); tokens = argmax of the engine's logits: {picked}; "
          f"dense argmax agrees on {dense_agree}/{steps + 1}")
    if quantized:  # information only: how far int8 KV moves the logits
        plain = dense_logits(torch, cfg, params, seq, steps + 1, kv_quant=False)
        rel_plain = ((got - plain).norm(dim=-1) / plain.norm(dim=-1)).tolist()
        print(f"  (information) engine int8 logits vs the unquantized dense forward: rel_l2 "
              f"{' '.join(f'{x:.3e}' for x in rel_plain)}")
    if not (max(rel) <= LOGITS_REL_TOL) or not picked or not bool(torch.isfinite(got).all()):
        raise AssertionError("the engine's logits disagree with the dense forward")


def serve_path(torch, cfg, params, name: str, ecfg, lens: list[int], must: set, must_not: set,
               logits_prompt: int, logits_steps: int, ttft_lens: tuple) -> tuple[dict, dict]:
    """Drive one engine path: a warm-up, then the path's requests with the
    launch counters reset just before and read just after, then the
    logits check and the timings. Returns (launches, timings)."""
    from gofr_tpu_torch import ServingEngine
    from gofr_tpu_torch.serving import batch as batch_ops
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    engine = ServingEngine(cfg, params, ecfg, ByteTokenizer(cfg.vocab_size), seed=SEED)
    rng = torch.Generator().manual_seed(SEED)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    layout = "dense" if engine.paged_cache is None else f"paged page={ecfg.kv_page_size}"
    weights = "int8" if isinstance(params["lm_head"], dict) else "bf16"
    print(f"engine path {name}: {layout} kv_dtype={ecfg.kv_dtype} weights={weights} "
          f"max_seq_len={ecfg.max_seq_len} chunk={engine._chunk_tokens} tokens; prompts {lens}, "
          f"chunked: {[n for n in lens if engine._route_chunked(n)]}")
    ragged_fn = getattr(batch_ops, ragged_name(engine))
    ragged_calls = [0]

    def count_ragged(*args):
        ragged_calls[0] += 1
        return ragged_fn(*args)

    engine.start()
    try:
        engine.submit(prompt(5), max_new_tokens=4).result(timeout=600)  # warm-up
        prompts = [prompt(n) for n in lens]
        # ---- the path: counters from 0, read right after
        kernels = counters()
        setattr(batch_ops, ragged_fn.__name__, count_ragged)
        for fn in kernels.values():
            fn.launches = 0
        try:
            futs = [
                engine.submit(p, max_new_tokens=32,
                              **(dict(temperature=0.8, top_k=50, top_p=0.95) if i == 3 else {}))
                for i, p in enumerate(prompts)
            ]
            results = [f.result(timeout=900) for f in futs]
        finally:
            launches = {n: fn.launches for n, fn in kernels.items()}
            setattr(batch_ops, ragged_fn.__name__, ragged_fn)
        for n, r in zip(lens, results):
            print(f"  prompt {n:4d} -> {r.completion_tokens:2d} tokens, {r.finish_reason}, "
                  f"ttft {r.ttft_s * 1e3:.1f} ms")
            if r.finish_reason not in ("length", "stop") or r.prompt_tokens != n:
                raise AssertionError(f"request with a {n}-token prompt ended {r.finish_reason}")
            if r.finish_reason == "length" and r.completion_tokens != 32:
                raise AssertionError("a length finish must carry 32 tokens")
            if any(not (0 <= t < cfg.vocab_size) for t in r.token_ids):
                raise AssertionError("token id outside the vocabulary")
        n_chunks = sum(math.ceil(n / engine._chunk_tokens) for n in lens if engine._route_chunked(n))
        print(f"  launches on path {name}: {launches}; ragged dispatches {ragged_calls[0]} "
              f"(chunks of the chunked prompts: {n_chunks})")
        if ragged_calls[0] < n_chunks or ragged_calls[0] > 0 and not n_chunks:
            raise AssertionError(f"path {name}: {ragged_calls[0]} ragged dispatches for {n_chunks} chunks")
        if not all(launches[n] for n in must) or any(launches[n] for n in must_not):
            raise AssertionError(f"path {name}: launches {launches}; must launch {sorted(must)}, "
                                 f"must not launch {sorted(must_not)}")

        check_engine_logits(torch, engine, prompt(logits_prompt), logits_steps)

        # ---- timings: TTFT alone, then a full batch of decode rows
        timings = {}
        for n in ttft_lens:
            r = engine.submit(prompt(n), max_new_tokens=2).result(timeout=600)
            timings[f"ttft_ms_prompt{n}_alone"] = r.ttft_s * 1e3
        batch = [engine.submit(prompt(20), max_new_tokens=65) for _ in range(8)]
        res = [f.result(timeout=900) for f in batch]
        per_step = sorted((r.duration_s - r.ttft_s) / (r.completion_tokens - 1) * 1e3 for r in res
                          if r.completion_tokens > 1)
        timings["decode_ms_per_step_batch8"] = per_step[len(per_step) // 2] if per_step else None
        timings["main_path_ttft_ms_max"] = max(r.ttft_s for r in results) * 1e3
        return launches, timings
    finally:
        engine.stop()


# ---------------------------------------------------------------- lifecycle
def wait_until(pred, timeout: float, what: str) -> None:
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out after {timeout:g}s waiting for {what}")
        time.sleep(0.002)


def check_clean(engine, what: str) -> None:
    """Every slot free, the scheduler's ``busy_slots`` at 0, no request
    left and, on the paged layout, every page back in the pool."""
    wait_until(lambda: all(s is None for s in engine.slots), 60, f"{what}: slots to free")
    stats = engine._sched.stats()
    if stats["busy_slots"] or engine._by_id:
        raise AssertionError(f"{what}: {stats['busy_slots']} busy slots, {len(engine._by_id)} "
                             "requests left")
    pc = engine.paged_cache
    if pc is not None and pc.stats()["free_blocks"] != pc.stats()["total_blocks"]:
        raise AssertionError(f"{what}: pages still owned: {pc.stats()}")


def hook_retires(engine) -> list:
    """Record each retire on the engine thread as (slot, request id,
    reason, perf_counter time); returns the record."""
    log, retire = [], engine._retire

    def recorded(slot, reason):
        req = engine.slots[slot]
        log.append((slot, req.id if req is not None else None, reason, time.perf_counter()))
        return retire(slot, reason)

    engine._retire = recorded
    return log


def hook_admissions(engine) -> list:
    """Record each (slot, request id) that reaches a prefill (whole, or a
    chunk cursor's start)."""
    log = []
    for name in ("_prefill_into", "_start_cursor"):
        real = getattr(engine, name)

        def spy(slot, req, _real=real):
            log.append((slot, req.id))
            return _real(slot, req)

        setattr(engine, name, spy)
    return log


def first_frames(order: list, key):
    """A stream_cb that appends ``key`` to ``order`` at its first token
    frame (frames arrive in emission order on the one detok worker)."""
    seen = []

    def cb(token_id, piece, done):
        if not done and not seen:
            seen.append(token_id)
            order.append(key)

    return cb


def per_step_ms(results) -> float | None:
    per = sorted((r.duration_s - r.ttft_s) / (r.completion_tokens - 1) * 1e3 for r in results
                 if r.completion_tokens > 1)
    return per[len(per) // 2] if per else None


def lifecycle_dense(torch, engine, prompt, errors) -> dict:
    """The dense engine's scenarios, in order; each a hard failure, each
    ending with every slot free. Returns their outcomes and the timings."""
    out = {}
    retires = hook_retires(engine)
    admitted = hook_admissions(engine)

    # 1. priority: 8 running, then 4 at priority 5 and 4 at priority 0
    fill = [engine.submit(prompt(20), max_new_tokens=48) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8 and not engine._sched.pending(),
               120, "the 8 slots to fill")
    order: list = []
    queued = [engine.submit(prompt(20), max_new_tokens=48, priority=p,
                            stream_cb=first_frames(order, p)) for p in (5,) * 4 + (0,) * 4]
    res = [f.result(timeout=600) for f in fill + queued]
    if order != [0] * 4 + [5] * 4 or any(r.finish_reason not in ("length", "stop") for r in res):
        raise AssertionError(f"priority: first tokens by class {order}")
    check_clean(engine, "priority")
    out["priority"] = {"first_token_classes": order}

    # 2. cancel a running row after its 8th token; a queued request takes its slot
    t_cancel = []

    seen: list = []

    def cancel_at_8(token_id, piece, done):
        if not done:
            seen.append(token_id)
            if len(seen) == 8:
                t_cancel.append(time.perf_counter())
                engine.cancel(target.request_id)

    others = [engine.submit(prompt(20), max_new_tokens=128) for _ in range(7)]
    target = engine.submit(prompt(20), max_new_tokens=512, stream_cb=cancel_at_8)
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    waiter = engine.submit(prompt(20), max_new_tokens=8)
    r = target.result(timeout=600)
    w = waiter.result(timeout=600)
    o = [f.result(timeout=600) for f in others]
    target_slot = next(s for s, rid in admitted if rid == target.request_id)
    waiter_slot = next(s for s, rid in admitted if rid == waiter.request_id)
    released = next(t for s, rid, why, t in retires if rid == target.request_id)
    if r.finish_reason != "cancel" or not 8 <= r.completion_tokens < 512 or waiter_slot != target_slot \
            or any(x.finish_reason not in ("length", "stop") for x in o + [w]):
        raise AssertionError(f"cancel: {r.finish_reason} after {r.completion_tokens} tokens; the "
                             f"waiter took slot {waiter_slot} (the canceled row's: {target_slot})")
    check_clean(engine, "cancel")
    cancel_ms = (released - t_cancel[0]) * 1e3
    out["cancel_running"] = {"finish_reason": r.finish_reason, "tokens": r.completion_tokens,
                             "waiter_took_slot": waiter_slot == target_slot, "cancel_to_release_ms": cancel_ms}

    # 4. deadlines: one that expires in the queue, one that expires mid-stream
    fill = [engine.submit(prompt(20), max_new_tokens=64) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    late = engine.submit(prompt(20), max_new_tokens=8, deadline=0.2)
    try:
        late.result(timeout=600)
        raise AssertionError("deadline: a request expired in the queue was served")
    except errors.ErrorDeadlineExceeded as exc:
        if exc.status_code != 504:
            raise AssertionError(f"deadline: status {exc.status_code}") from None
    if any(rid == late.request_id for _, rid in admitted):
        raise AssertionError("deadline: the expired request reached a prefill")
    [f.result(timeout=600) for f in fill]
    r = engine.submit(prompt(20), max_new_tokens=1000, deadline=1.0).result(timeout=600)
    if r.finish_reason != "deadline_exceeded" or not 0 < r.completion_tokens < 1000:
        raise AssertionError(f"deadline: mid-stream {r.finish_reason} after {r.completion_tokens}")
    check_clean(engine, "deadlines")
    out["deadlines"] = {"queued": 504, "mid_stream": r.finish_reason, "mid_stream_tokens": r.completion_tokens}

    # 5. callbacks: one that raises cancels; one that blocks stalls only the detok worker
    def raises(token_id, piece, done):
        raise RuntimeError("client gone")

    r = engine.submit(prompt(20), max_new_tokens=200, stream_cb=raises).result(timeout=600)
    if r.finish_reason != "cancel" or r.completion_tokens >= 200:
        raise AssertionError(f"callbacks: a raising stream_cb gave {r.finish_reason}")
    release = threading.Event()

    def blocks(token_id, piece, done):
        release.wait(timeout=600)

    n0 = len(retires)
    futs = [engine.submit(prompt(20), max_new_tokens=65, stream_cb=blocks if i == 0 else None)
            for i in range(8)]
    rids = {f.request_id for f in futs[1:]}
    wait_until(lambda: sum(1 for _, rid, why, _ in retires[n0:]
                           if rid in rids and why in ("length", "stop")) == 7,
               300, "the 7 other rows to finish while a callback blocks")
    blocked_done = [f.done() for f in futs]
    release.set()
    res = [f.result(timeout=600) for f in futs]
    if any(x.finish_reason not in ("length", "stop") for x in res):
        raise AssertionError("callbacks: a row behind a blocking callback did not finish")
    check_clean(engine, "callbacks")
    out["callbacks"] = {"raising": r.finish_reason, "raising_tokens": r.completion_tokens,
                        "others_retired_while_blocked": 7,
                        "futures_done_while_blocked": sum(blocked_done)}

    # 6. stream(): whole, and left after 4 tokens
    futs = []
    submit = engine.submit

    def spy(*a, **kw):
        futs.append(submit(*a, **kw))
        return futs[-1]

    engine.submit = spy

    async def consume():
        whole, early, final = [], [], {}
        async for tid, _ in engine.stream(prompt(20), max_new_tokens=16,
                                          on_result=lambda res: final.setdefault("r", res)):
            whole.append(tid)
        agen = engine.stream(prompt(20), max_new_tokens=512)
        async for tid, _ in agen:
            early.append(tid)
            if len(early) == 4:
                break
        await agen.aclose()
        return whole, early, final["r"]

    try:
        whole, early, final = asyncio.run(consume())
    finally:
        del engine.submit
    left = futs[1].result(timeout=600)
    if whole != final.token_ids or left.finish_reason != "cancel":
        raise AssertionError(f"stream: {len(whole)} streamed tokens against {final.token_ids}; "
                             f"leaving early gave {left.finish_reason}")
    check_clean(engine, "stream")
    out["stream"] = {"tokens_equal_result": True, "left_early": left.finish_reason,
                     "left_early_tokens": left.completion_tokens}

    # 7. over-long prompt (C7): 2100 tokens at max_seq_len 2048
    ragged = [0]
    dispatch_ragged = engine._dispatch_ragged

    def count(*a):
        ragged[0] += 1
        return dispatch_ragged(*a)

    engine._dispatch_ragged = count
    try:
        r = engine.submit(prompt(2100), max_new_tokens=32).result(timeout=600)
    finally:
        del engine._dispatch_ragged
    if (r.prompt_tokens, r.completion_tokens, r.finish_reason) != (2047, 1, "length") or ragged[0] < 8:
        raise AssertionError(f"over-long: {r.prompt_tokens} prompt tokens, {r.completion_tokens} "
                             f"tokens, {r.finish_reason}, {ragged[0]} ragged dispatches")
    check_clean(engine, "over-long")
    out["over_long"] = {"prompt_tokens": r.prompt_tokens, "tokens": r.completion_tokens,
                        "finish_reason": r.finish_reason, "ragged_dispatches": ragged[0]}

    # 8. shed: 1 ms of estimated wait, the estimator seeded by the requests above
    fill = [engine.submit(prompt(20), max_new_tokens=64) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    behind = engine.submit(prompt(20), max_new_tokens=8)
    shed = {}
    for how in ("threshold", "deadline"):
        engine.config.shed_max_wait_s = 0.001 if how == "threshold" else 0.0
        try:
            engine.submit(prompt(20), max_new_tokens=8, deadline=0.001 if how == "deadline" else None)
            raise AssertionError(f"shed: the {how} submit was accepted")
        except errors.ErrorTooManyRequests as exc:
            if not exc.retry_after or exc.retry_after <= 0:
                raise AssertionError(f"shed: retry_after {exc.retry_after}") from None
            shed[how] = {"status": exc.status_code, "retry_after_s": exc.retry_after}
    [f.result(timeout=600) for f in fill + [behind]]
    check_clean(engine, "shed")
    out["shed"] = shed

    # timings, for information: ms per decode step at batch 8, without
    # and with a stream_cb on every row
    def noop(token_id, piece, done):
        pass

    timing = {}
    for name, cb in (("decode_ms_per_step_b8_no_cb", None), ("decode_ms_per_step_b8_cb", noop)):
        res = [f.result(timeout=600) for f in
               [engine.submit(prompt(20), max_new_tokens=65, stream_cb=cb) for _ in range(8)]]
        timing[name] = per_step_ms(res)
    check_clean(engine, "timings")
    timing["cancel_to_release_ms"] = cancel_ms

    # 9. drain over 8 running requests, then a refused submit
    futs = [engine.submit(prompt(20), max_new_tokens=32) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    if engine.drain(120) is not True:
        raise AssertionError("drain(120) did not finish the work in hand")
    res = [f.result(timeout=1) for f in futs]
    if any(x.finish_reason not in ("length", "stop") for x in res):
        raise AssertionError("drain: a request did not finish")
    try:
        engine.submit(prompt(5))
        raise AssertionError("drain: a submit after drain was accepted")
    except errors.ErrorServiceUnavailable as exc:
        if exc.status_code != 503 or "Retry-After" not in exc.response_headers():
            raise AssertionError("drain: the refusal is not a retriable 503") from None
    if any(s is not None for s in engine.slots) or engine._sched.stats()["busy_slots"]:
        raise AssertionError("drain: slots left busy")
    out["drain"] = {"drained": True, "after": 503}
    return out, timing


def lifecycle_drain_deadline(torch, engine, prompt, errors) -> dict:
    """drain(0) over 8 running requests on a fresh engine: False, each
    request ends with a result or a retriable 503, the thread exits."""
    engine.start()
    futs = [engine.submit(prompt(20), max_new_tokens=512) for _ in range(8)]
    wait_until(lambda: engine._sched.stats()["busy_slots"] == 8, 120, "the 8 slots to fill")
    if engine.drain(0) is not False:
        raise AssertionError("drain(0) over running work returned True")
    ends = []
    for f in futs:
        try:
            ends.append(f.result(timeout=60).finish_reason)
        except errors.ErrorServiceUnavailable as exc:
            if exc.retry_after is None:
                raise AssertionError("drain(0): a 503 without retry_after") from None
            ends.append(503)
    if engine._thread is not None and engine._thread.is_alive():
        raise AssertionError("drain(0): the engine thread did not exit")
    if any(s is not None for s in engine.slots) or engine._sched.stats()["busy_slots"]:
        raise AssertionError("drain(0): slots left busy")
    return {"drained": False, "ends": ends}


def lifecycle_paged(torch, engine, prompt) -> dict:
    """Cancel mid-chunk on the paged int8 engine: a 3000-token prompt
    beside two decoding rows, canceled after its first ragged dispatch."""
    pc = engine.paged_cache
    free0 = pc.stats()["free_blocks"]
    target: list = []
    dispatch_ragged = engine._dispatch_ragged

    def cancel_after_first(state, chunk_rows, steps):
        out = dispatch_ragged(state, chunk_rows, steps)
        if target and any(req.id == target[0].request_id for _, _, req, _, _ in chunk_rows) \
                and len(target) == 1:
            target.append(time.perf_counter())
            engine.cancel(target[0].request_id)
        return out

    engine._dispatch_ragged = cancel_after_first
    try:
        rows = [engine.submit(prompt(20), max_new_tokens=64) for _ in range(2)]
        wait_until(lambda: engine._sched.stats()["busy_slots"] == 2, 120, "two decoding rows")
        target.append(engine.submit(prompt(3000), max_new_tokens=8))
        r = target[0].result(timeout=600)
        res = [f.result(timeout=600) for f in rows]
    finally:
        del engine._dispatch_ragged
    if r.finish_reason != "cancel" or r.completion_tokens != 0 or len(target) != 2 \
            or any(x.finish_reason not in ("length", "stop") for x in res):
        raise AssertionError(f"cancel mid-chunk: {r.finish_reason} after {r.completion_tokens} tokens")
    check_clean(engine, "cancel mid-chunk")
    if pc.stats()["free_blocks"] != free0:
        raise AssertionError(f"cancel mid-chunk: {pc.stats()['free_blocks']} free pages, {free0} before")
    return {"finish_reason": r.finish_reason, "tokens": r.completion_tokens,
            "free_pages_restored": free0}


def check_prefill_c9(torch, cfg, params, prompt) -> dict:
    """C9 on the card: ``llama.prefill`` into a bf16 and an int8 KVCache
    (B=1, a 700-token prompt) against ``prefill_compute``'s slabs."""
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch as batch_ops

    dev = params["embedding"].device
    tokens = torch.tensor([prompt(700)], device=dev)
    lens = torch.tensor([700], dtype=torch.int32, device=dev)
    want, k_slab, v_slab = batch_ops.prefill_compute(cfg, params, tokens, lens)
    out = {}
    for kv_dtype in (None, "int8"):
        cache = llama.KVCache.create(cfg, 1, max_len=700, kv_dtype=kv_dtype, device=dev)
        got, cache = llama.prefill(cfg, params, tokens, cache, lens)
        rel = ((got - want).norm() / want.norm()).item()
        if kv_dtype is None:
            same = torch.equal(cache.k[:, 0], k_slab) and torch.equal(cache.v[:, 0], v_slab)
        else:
            (kq, ks), (vq, vs) = llama.quantize_kv(k_slab), llama.quantize_kv(v_slab)
            same = all(torch.equal(a, b) for a, b in zip(
                (cache.k[:, 0], cache.v[:, 0], cache.ks[:, 0], cache.vs[:, 0]), (kq, vq, ks, vs)))
        name = kv_dtype or "bf16"
        print(f"  C9 llama.prefill into a {name} KVCache (700 tokens): logits rel_l2 {rel:.3e} "
              f"(tol {LOGITS_REL_TOL}), cache rows equal {'quantize_kv(slabs)' if kv_dtype else 'the slabs'}: {same}")
        if not (rel <= LOGITS_REL_TOL) or not same:
            raise AssertionError(f"C9: llama.prefill into a {name} cache disagrees with prefill_compute")
        out[name] = {"logits_rel_l2": rel, "cache_equal": same}
    return out


def run_lifecycle(torch, cfg, params) -> dict:
    """The lifecycle phase at Llama-3-8B widths: the dense engine (the
    reference's defaults) and the paged int8 engine, each with the launch
    counters reset just before its scenarios and read just after; then a
    fresh dense engine for drain(0), and C9's prefill check."""
    from gofr_tpu_torch import EngineConfig, ServingEngine, errors
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    rng = torch.Generator().manual_seed(SEED + 1)

    def prompt(n: int) -> list[int]:
        return torch.randint(3, cfg.vocab_size, (n,), generator=rng).tolist()

    dense_cfg = dict(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                     prefill_chunk_tokens=256)
    paged_cfg = dict(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32,
                     kv_dtype="int8", multi_step=4, prefill_chunk_tokens=256)
    kernels = counters()
    result = {"launches": {}}

    def engine_of(conf):
        engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(cfg.vocab_size), seed=SEED)
        engine.start()
        engine.submit(prompt(5), max_new_tokens=4).result(timeout=600)  # warm-up
        check_clean(engine, "warm-up")
        for fn in kernels.values():
            fn.launches = 0
        return engine

    t0 = time.perf_counter()
    engine = engine_of(dense_cfg)
    try:
        result["dense"], timing = lifecycle_dense(torch, engine, prompt, errors)
    finally:
        result["launches"]["dense"] = {n: fn.launches for n, fn in kernels.items()}
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    engine = engine_of(paged_cfg)
    try:
        result["paged_int8"] = {"cancel_mid_chunk": lifecycle_paged(torch, engine, prompt)}
    finally:
        result["launches"]["paged_int8"] = {n: fn.launches for n, fn in kernels.items()}
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    engine = ServingEngine(cfg, params, EngineConfig(**dense_cfg), ByteTokenizer(cfg.vocab_size), seed=SEED)
    result["dense"]["drain_deadline"] = lifecycle_drain_deadline(torch, engine, prompt, errors)
    del engine
    torch.cuda.empty_cache()
    result["c9_prefill"] = check_prefill_c9(torch, cfg, params, prompt)
    launches = result["launches"]
    if not (launches["dense"]["flash_attention"] and launches["paged_int8"]["flash_attention"]
            and launches["paged_int8"]["paged_decode_attention_q"]) \
            or launches["dense"]["paged_decode_attention"] or launches["dense"]["paged_decode_attention_q"]:
        raise AssertionError(f"lifecycle launches {launches}")
    result["timing"] = timing
    result["seconds"] = time.perf_counter() - t0
    print(f"  lifecycle: launches {launches}; timings {timing}; {result['seconds']:.1f}s")
    return result


def run_engine(torch) -> tuple[dict, dict, dict]:
    from gofr_tpu_torch import EngineConfig, LlamaConfig
    from gofr_tpu_torch.models.llama import init_params, param_bytes, quantize_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + params["embedding"].numel() \
        + params["lm_head"].numel()
    print(f"engine: Llama-3-8B widths, {cfg.n_layers} layers, {n_params / 1e9:.2f}B params "
          f"bf16, random init in {time.perf_counter() - t0:.1f}s")
    launches, timings = {}, {}
    # bf16: the monolithic path as it was; a chunk of 2048 keeps every prompt up
    # to the largest bucket monolithic. 45 tokens: decode crosses a page
    # boundary at 48
    launches["bf16"], timings["bf16"] = serve_path(
        torch, cfg, params, "bf16",
        EngineConfig(max_slots=8, max_seq_len=2048, kv_layout="paged", kv_page_size=16,
                     multi_step=4, max_new_tokens_default=32, prefill_chunk_tokens=2048),
        MAIN_LENS, must={"flash_attention", "paged_decode_attention"},
        must_not={"paged_decode_attention_q"}, logits_prompt=45, logits_steps=8,
        ttft_lens=(100, 1000),
    )
    torch.cuda.empty_cache()
    # int8: the reference's 256-token chunks; 600 tokens make three chunks
    # and ten decode steps write positions 600-609, across the page
    # boundary at 608
    launches["int8"], timings["int8"] = serve_path(
        torch, cfg, params, "int8",
        EngineConfig(max_slots=8, max_seq_len=4096, kv_layout="paged", kv_page_size=32,
                     multi_step=4, max_new_tokens_default=32, prefill_chunk_tokens=256,
                     kv_dtype="int8"),
        MAIN_LENS + [LONG_PROMPT], must={"flash_attention", "paged_decode_attention_q"},
        must_not={"paged_decode_attention"}, logits_prompt=600, logits_steps=10,
        ttft_lens=(1000,),
    )
    torch.cuda.empty_cache()
    # dense: the reference's defaults (dense layout, bf16 KV, 256-token
    # chunks); 333, 480, 777 and 1000 chunk through the dense ragged
    # dispatch. 45 tokens prefill whole, as on the bf16 path
    launches["dense"], timings["dense"] = serve_path(
        torch, cfg, params, "dense",
        EngineConfig(max_slots=8, max_seq_len=2048, kv_layout="dense", multi_step=4,
                     max_new_tokens_default=32, prefill_chunk_tokens=256),
        MAIN_LENS, must={"flash_attention"},
        must_not={"paged_decode_attention", "paged_decode_attention_q"}, logits_prompt=45,
        logits_steps=8, ttft_lens=(100, 1000),
    )
    torch.cuda.empty_cache()
    # dense-w8: int8 KV and weight-only int8 params made on the card from
    # the same weights (the embedding is shared, not copied); 600 tokens
    # make three chunks
    t0 = time.perf_counter()
    params_w8 = quantize_params(params)
    torch.cuda.synchronize()
    print(f"weight-only int8: quantize_params in {time.perf_counter() - t0:.1f}s, "
          f"{param_bytes(params_w8) / 1e9:.2f} GB (bf16 tree {param_bytes(params) / 1e9:.2f} GB)")
    launches["dense-w8"], timings["dense-w8"] = serve_path(
        torch, cfg, params_w8, "dense-w8",
        EngineConfig(max_slots=8, max_seq_len=4096, kv_layout="dense", multi_step=4,
                     max_new_tokens_default=32, prefill_chunk_tokens=256, kv_dtype="int8"),
        MAIN_LENS + [LONG_PROMPT], must={"flash_attention"},
        must_not={"paged_decode_attention", "paged_decode_attention_q"}, logits_prompt=600,
        logits_steps=10, ttft_lens=(1000,),
    )
    torch.cuda.empty_cache()
    print("dispatch time against kernel time (torch.profiler):")
    timings["dispatch_busy"] = dispatch_busy(torch, cfg, params, params_w8)
    del params_w8
    torch.cuda.empty_cache()
    print("lifecycle phase (dense bf16 and paged int8 engines, full depth):")
    lifecycle = run_lifecycle(torch, cfg, params)
    return launches, timings, lifecycle


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
    ptxas_jobs = start_ptxas(_build)
    try:
        _build.build_all()
    except BaseException:
        for proc in ptxas_jobs.values():  # stop the report's compiles too
            proc.kill()
            proc.wait()
        raise
    print(f"kernels built in {time.perf_counter() - t0:.1f}s ({_build.BUILD_DIR})")
    ptxas = ptxas_report(ptxas_jobs)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = check_kernels(torch, gen)

    launches, engine_timings, lifecycle = run_engine(torch)
    timer = Timer(torch)
    rows = time_kernels(torch, gen, timer, errs, launches)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}")
    print(json.dumps({"information": time_information(torch, gen, timer), "ptxas": ptxas}))
    print(json.dumps({"engine": engine_timings}))
    print(card)
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
