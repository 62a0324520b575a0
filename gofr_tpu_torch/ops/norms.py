"""Normalization ops (port of ``gofr_tpu/ops/norms.py``): RMSNorm and
LayerNorm, both accumulated in float32 and cast back to the activation
dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float()).to(dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """LayerNorm with the biased variance (``jnp.var``), f32 inside."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float() + bias.float()).to(dtype)
