"""Rotary position embeddings (port of ``gofr_tpu/ops/rope.py``),
half-rotation layout: the first and second halves of the head dimension
rotate as a pair (``x1*cos - x2*sin``), not interleaved even/odd lanes."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=8)
def rope_table(
    max_len: int, head_dim: int, theta: float = 10000.0,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape [max_len, head_dim//2], float32. Cached
    per (length, width, theta, device): a decode step reads the table of
    every layer, and rebuilding it would cost four launches per step. The
    cached tensors are shared and must not be written."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    angles = torch.arange(max_len, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(
    x: torch.Tensor,  # [..., seq, heads, head_dim]
    positions: torch.Tensor,  # [..., seq] int
    sin_table: torch.Tensor,
    cos_table: torch.Tensor,
) -> torch.Tensor:
    dtype = x.dtype
    sin = sin_table[positions][..., :, None, :]  # [..., seq, 1, half]
    cos = cos_table[positions][..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)
