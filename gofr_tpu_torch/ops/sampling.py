"""Token sampling (port of ``gofr_tpu/ops/sampling.py``): greedy,
temperature, top-k and top-p through masks, with no data-dependent shapes
and no host sync, so it runs inside the N-step decode block.

Draws come from the ``torch.Generator`` passed in (a Gumbel-max draw over
the masked logits). They do not reproduce ``jax.random.categorical``'s
bits; temperature 0 is an exact argmax in both.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _rows(x, ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A scalar or [B] parameter as a [B, 1] tensor on ref's device."""
    t = torch.as_tensor(x, dtype=dtype, device=ref.device)
    return t.reshape(1, 1) if t.ndim == 0 else t[:, None]


def sample_logits(
    logits: torch.Tensor,  # [B, vocab]
    generator: torch.Generator,
    *,
    temperature: torch.Tensor | float = 1.0,
    top_k: torch.Tensor | int = 0,  # 0 = disabled
    top_p: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """Sampled token ids [B] (int64). ``temperature <= 0`` rows take the
    exact argmax. Per-row parameters may be [B] tensors."""
    logits = logits.float()
    B, vocab = logits.shape
    temp = _rows(temperature, logits, torch.float32)
    k = _rows(top_k, logits, torch.int64)
    p_top = _rows(top_p, logits, torch.float32)

    greedy_ids = torch.argmax(logits, dim=-1)
    scaled = logits / torch.where(temp > 0, temp, torch.ones_like(temp))

    # top-k: keep logits >= the k-th largest
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (torch.where(k > 0, k, torch.full_like(k, vocab)) - 1).clamp(0, vocab - 1)
    kth = torch.gather(sorted_desc, -1, k_idx.expand(B, 1))
    neg = torch.full((), NEG_INF, device=logits.device)
    scaled = torch.where(scaled >= kth, scaled, neg)

    # top-p: keep the smallest prefix (in sorted order) whose mass reaches p
    sorted_scaled = torch.sort(scaled, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_scaled, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep = (cum - probs_sorted) < p_top
    threshold = torch.where(keep, sorted_scaled, torch.full((), float("inf"), device=logits.device))
    threshold = threshold.amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled >= threshold, scaled, neg)

    # Gumbel-max: argmax(logits + G) is a draw from softmax(logits)
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where((temp <= 0)[:, 0].expand(B), greedy_ids, sampled)


def stop_eval(
    next_token: torch.Tensor,  # [B] the token each row just emitted
    stop_tok: torch.Tensor,  # [B] per-row stop (EOS) id; -1 disables
    budget: torch.Tensor,  # [B] tokens the row may still emit, INCLUDING this one
) -> torch.Tensor:
    """On-device stop condition: the row just emitted its stop token, or
    that token spent the last of its budget. Returns done [B] bool."""
    return (next_token == stop_tok) | (budget <= 1)
