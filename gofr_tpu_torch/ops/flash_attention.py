"""Flash-prefill attention (port of ``gofr_tpu/ops/flash_attention.py``).

``flash_attention`` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu`` for CUDA tensors and runs
:func:`flash_attention_ref` for CPU tensors. It replaces the Pallas TPU
kernel ``gofr_tpu/ops/flash_attention.py::_flash_kernel``. The kernel is
built for Hopper: a producer warp fills a ring of K/V tiles by TMA while
two consumer warpgroups, 64 query rows each, run QKᵀ and PV on ``wgmma``
with the softmax state in f32 registers (the file's header gives its bound
on the H100 and the design). It reads q, k and v through tensor maps
encoded on the host for each call, so it takes them contiguous; TMA
zero-fills rows past the sequence and the kernel masks ``kv_len`` and the
causal edge itself, so any prefill bucket works, not only multiples of
the tile.
"""

from __future__ import annotations

import math

import torch

from gofr_tpu_torch import _build
from gofr_tpu_torch.ops.attention import attention


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    kv_len: torch.Tensor | None = None,  # [B]
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """The kernel's plain version: dense masked attention (``attention``
    with ``q_offset=0``), plus the kernel's denominator guard: a row with
    no valid key (``kv_len`` 0) gives 0 where the dense softmax over
    all -1e30 logits would give the mean of V."""
    out = attention(q, k, v, causal=causal, kv_len=kv_len, scale=scale)
    if kv_len is None:
        return out
    return torch.where((kv_len.to(q.device) > 0)[:, None, None, None], out, torch.zeros_like(out))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor | None = None,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal prefill attention, [B, Sq, H, D] out in q's dtype; keys at or
    past ``kv_len[b]`` are masked. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which takes contiguous bf16 q/k/v with head
    dim 64 or 128 and int32 ``kv_len``, and raises on anything else."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_len, causal=causal, scale=scale)
    if kv_len is None:
        kv_len = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    _check_inputs(q, k, v, kv_len)
    out = torch.empty_like(q)
    status = _build.library("flash_attention").gofr_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, D, float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches (CPU calls never count)


def _check_inputs(q, k, v, kv_len) -> None:
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads do not group over {Hkv} kv heads")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: the kernel takes head dim 64 or 128, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: kernel takes bf16 {name}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous, 16-byte aligned tensor on {q.device}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError("flash_attention: kv_len must be int32 [B] on the same device")
    if not kv_len.is_contiguous():
        raise ValueError("flash_attention: kv_len must be contiguous")
