"""``x @ w`` with an f32 result from bf16 operands: the port of the
reference's ``jnp.einsum(..., preferred_element_type=jnp.float32)``, which
the Llama and Whisper logits use."""

from __future__ import annotations

import torch


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated AND returned in f32 from bf16 operands
    (``preferred_element_type=f32``): a bf16 product cast afterwards would
    round the logits and change greedy ties."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:  # bf16 products are exact in f32
        y = x2.float() @ w.float()
    return y.reshape(*x.shape[:-1], w.shape[-1])
