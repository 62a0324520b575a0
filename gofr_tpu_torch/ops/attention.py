"""Attention ops (port of ``gofr_tpu/ops/attention.py``), plain PyTorch.

Layout everywhere: ``[batch, seq, heads, head_dim]``. GQA contracts the
grouped queries ``[B, Sq, Hkv, G, D]`` against the unexpanded K/V, never a
repeated copy. Logits and softmax are float32; masked logits are -1e30.

``attention`` is also the plain version of the flash-prefill kernel
(``ops/flash_attention.py``); ``decode_attention`` is the dense
single-token decode read.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,  # int, or [B] per-row offsets
    kv_len: torch.Tensor | None = None,  # [B] valid KV length per row
    scale: float | None = None,
) -> torch.Tensor:
    """Dense attention, GQA-native. ``q_offset`` is the absolute position
    of q[0]: one int for every row, or a [B] tensor when each row's chunk
    starts elsewhere (chunked prefill over a shared pool, where row b's
    query i sits at ``q_offset[b] + i``); ``kv_len`` masks right-padded
    K/V. The logits are exact f32 products of the inputs (what
    ``preferred_element_type=f32`` computes); the probabilities are
    rounded to v's dtype before the PV product, as the reference does."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D)

    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale

    dev = q.device
    mask = None
    if causal:
        k_pos = torch.arange(Sk, device=dev)
        if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
            q_pos = q_offset.to(dev)[:, None] + torch.arange(Sq, device=dev)[None, :]  # [B, Sq]
            mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None]  # [B,1,1,Sq,Sk]
        else:
            q_pos = torch.arange(Sq, device=dev)[:, None] + q_offset  # [Sq, 1]
            mask = (k_pos[None, :] <= q_pos)[None, None, None]
    if kv_len is not None:
        valid = torch.arange(Sk, device=dev)[None, :] < kv_len.to(dev)[:, None]
        valid = valid[:, None, None, None, :]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), NEG_INF, device=dev))

    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype).reshape(B, Sq, H, D)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D] one new token per row
    k_cache: torch.Tensor,  # [B, S_max, Hkv, D]
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # [B] valid entries (including the new token)
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-step decode against a dense KV cache with per-row lengths."""
    return attention(
        q, k_cache, v_cache, causal=False, kv_len=cache_len, scale=scale
    )
