"""Mixture-of-Experts ops without a mesh (port of ``gofr_tpu/ops/moe.py``):
top-k routing, the Switch load-balance statistics, the GShard
dispatch/combine tensors, the per-expert SwiGLU FFN and the dense
reference FFN. Plain PyTorch: the reference's are plain XLA einsums (no
Pallas kernel). The expert-parallel ``moe_ffn_ep`` / ``moe_ffn_ep_sharded``
(``shard_map`` and two ``all_to_all`` over the ``ep`` axis) wait for the
parallel plane (ROADMAP Queue A item 9).

Capacity model (for the dispatch tensors): each expert accepts at most C
tokens (C = ceil(top_k · tokens / E · capacity_factor)); overflow tokens
get a zero expert contribution and the combine weights are renormalized
over the surviving assignments.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def router_topk(
    x: torch.Tensor,  # [T, D]
    w_router: torch.Tensor,  # [D, E]
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating: (expert_idx [T, k] int64, gate_weights [T, k],
    full_probs [T, E]); the weights are softmax probs renormalized over the
    selected k; the full probs feed the load-balance aux loss."""
    # bf16 activations against the f32 router promote, as jnp's @ does
    dt = torch.promote_types(x.dtype, w_router.dtype)
    logits = (x.to(dt) @ w_router.to(dt)).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    return top_i, top_p, probs


def switch_aux_stats(
    top_i: torch.Tensor,  # [T, k]
    probs: torch.Tensor,  # [T, E]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-expert (f_e, P_e) from the ACTUAL routing: f_e the fraction of
    tokens whose top-1 choice is e, P_e the mean router prob."""
    n_experts = probs.shape[-1]
    f = F.one_hot(top_i[:, 0], n_experts).float().mean(dim=0)
    p = probs.mean(dim=0)
    return f, p


def _dispatch_combine(
    top_i: torch.Tensor,  # [T, k]
    top_p: torch.Tensor,  # [T, k]
    n_experts: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard dispatch [T, E, C] (one-hot) and combine [T, E, C]
    (gate-weighted). A token's slot in its expert's buffer is its routing
    order (a cumsum over (token, k))."""
    T, k = top_i.shape
    onehot = F.one_hot(top_i, n_experts).float()  # [T, k, E]
    flat = onehot.reshape(T * k, n_experts)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(T, k, n_experts)
    keep = onehot * (pos < capacity).float()  # [T, k, E]
    pos_idx = (pos * onehot).sum(dim=-1).long()  # [T, k]
    # a slot past the capacity is dropped by ``keep``; clamp its index so
    # the one-hot has a place for it (the reference's one_hot gives zeros)
    cap_onehot = F.one_hot(pos_idx.clamp_max(capacity - 1), capacity).float()
    cap_onehot = cap_onehot * (pos_idx < capacity).float()[..., None]  # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", keep, cap_onehot)
    combine = torch.einsum("tke,tkc,tk->tec", keep, cap_onehot, top_p.float())
    surv = combine.sum(dim=(1, 2))
    combine = combine / (surv[:, None, None] + 1e-9)
    mask_any = (dispatch.sum(dim=(1, 2)) > 0)[:, None, None]
    combine = torch.where(mask_any, combine, torch.zeros((), device=combine.device))
    return dispatch, combine


def expert_ffn(
    h: torch.Tensor,  # [E, N, D] tokens grouped per expert
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,  # [E, D, F]
    w_down: torch.Tensor,  # [E, F, D]
) -> torch.Tensor:
    """SwiGLU FFN per expert: batched GEMMs over the expert axis, the SiLU
    gate in f32."""
    gate = torch.bmm(h, w_gate)
    up = torch.bmm(h, w_up)
    act = F.silu(gate.float()).to(h.dtype) * up
    return torch.bmm(act, w_down)


def capacity_for(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    return max(1, math.ceil(top_k * tokens / n_experts * factor))


def moe_ffn_reference(
    x: torch.Tensor,  # [T, D]
    w_router: torch.Tensor,
    w_gate: torch.Tensor,  # [E, D, F]
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    top_k: int = 2,
    return_stats: bool = False,
):
    """Dense reference (no capacity drops, no expert parallelism): every
    expert computes every token, combined by the top-k gates."""
    top_i, top_p, probs = router_topk(x, w_router, top_k)
    n_experts = w_gate.shape[0]
    all_out = expert_ffn(x.expand(n_experts, *x.shape), w_gate, w_up, w_down)  # [E, T, D]
    onehot = F.one_hot(top_i, n_experts).float()  # [T, k, E]
    weights = torch.einsum("tke,tk->te", onehot, top_p)  # [T, E]
    y = torch.einsum("etd,te->td", all_out.float(), weights).to(x.dtype)
    if return_stats:
        f, p = switch_aux_stats(top_i, probs)
        return y, f, p
    return y
