"""``x @ w`` with an f32 result from bf16 operands: the port of the
reference's ``jnp.einsum(..., preferred_element_type=jnp.float32)``, which
the Llama and Whisper logits use."""

from __future__ import annotations

import torch


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(..., out_dtype=f32)`` has no derivative in PyTorch, so the
    card's f32-out GEMM carries its own backward: ``dx = g @ wᵀ`` and
    ``dw = xᵀ @ g`` with the f32 gradient rounded to the operands' dtype
    and accumulated in f32 inside the GEMM, the gradients in the operands'
    dtype (what autograd of ``x.float() @ w.float()`` returns after its
    casts, up to the rounding of ``g``)."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = g.to(w.dtype) @ w.T
        if ctx.needs_input_grad[1]:
            dw = x2.T @ g.to(x2.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated AND returned in f32 from bf16 operands
    (``preferred_element_type=f32``): a bf16 product cast afterwards would
    round the logits and change greedy ties. Differentiable on the card
    through :class:`_MatmulF32` (the training step's logits)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = _MatmulF32.apply(x2, w)
    else:  # bf16 products are exact in f32
        y = x2.float() @ w.float()
    return y.reshape(*x.shape[:-1], w.shape[-1])
