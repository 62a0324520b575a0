"""Mixture-of-Experts ops (port of ``gofr_tpu/ops/moe.py``):
top-k routing, the Switch load-balance statistics, the GShard
dispatch/combine tensors, the per-expert SwiGLU FFN, the dense reference
FFN and the expert-parallel FFN over the ``ep`` mesh axis
(``moe_ffn_ep``/``moe_ffn_ep_sharded``: tokens grouped per rank, two tiled
``all_to_all`` carry each group's dispatched tokens to the ranks owning
their experts and back). Plain PyTorch: the reference's are plain XLA
einsums (no Pallas kernel).

Capacity model (for the dispatch tensors): each expert accepts at most C
tokens (C = ceil(top_k · tokens / E · capacity_factor)); overflow tokens
get a zero expert contribution and the combine weights are renormalized
over the surviving assignments.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gofr_tpu_torch.parallel.collectives import all_to_all, copy_to, gather_from, pmean, split_to
from gofr_tpu_torch.parallel.mesh import Mesh, require_axis


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


def moe_ffn_ep_sharded(
    x: torch.Tensor,  # [t, D] this rank's token group
    w_router: torch.Tensor,  # [D, E] replicated
    w_gate: torch.Tensor,  # [E_loc, D, F] this rank's experts
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str,
    n_experts: int,
    top_k: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-rank body: route locally, all_to_all tokens to expert owners,
    run local experts, all_to_all back, combine. Also returns the global
    (pmean over the axis) per-expert (f_e, P_e) aux-loss stats."""
    n = require_axis(mesh, axis)
    e_loc = n_experts // n
    top_i, top_p, probs = router_topk(x, w_router, top_k)
    f_loc, p_loc = switch_aux_stats(top_i, probs)
    f = pmean(f_loc, mesh, axis)
    p = pmean(p_loc, mesh, axis)
    dispatch, combine = _dispatch_combine(top_i, top_p, n_experts, capacity)

    # [t, E, C] x [t, D] -> [E, C, D], grouped by owning rank
    sent = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    sent = sent.reshape(n, e_loc, capacity, -1)
    # rank g receives, from every peer, the block destined for g's experts;
    # afterwards axis 0 indexes the source group
    recv = all_to_all(sent, mesh, axis, split_axis=0, concat_axis=0)
    h = recv.transpose(0, 1).reshape(e_loc, n * capacity, -1)  # [E_loc, N, D]
    out = expert_ffn(h, w_gate, w_up, w_down)  # [E_loc, N, D]
    out = out.reshape(e_loc, n, capacity, -1).transpose(0, 1).contiguous()  # [n, E_loc, C, D]
    back = all_to_all(out, mesh, axis, split_axis=0, concat_axis=0)
    back = back.reshape(n_experts, capacity, -1)  # [E, C, D] for this group
    y = torch.einsum("ecd,tec->td", back.float(), combine).to(x.dtype)
    return y, f, p


def moe_ffn_ep(
    x: torch.Tensor,  # [T, D] the global tokens, the same on every rank
    w_router: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor,  # [E, D, F], or this rank's [E/n, D, F]
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "ep",
    top_k: int = 2,
    capacity_factor: float = 1.25,
    capacity: int | None = None,
    return_stats: bool = False,
):
    """Expert-parallel MoE FFN: tokens grouped on ``axis``, experts sharded
    on ``axis``, two all_to_all transposes. The expert weights are all E
    experts (each rank keeps its own) or this rank's E/n, as
    ``shard_params`` with ``moe_sharding_rules`` leaves them. The output
    (and with ``return_stats`` the global per-expert (f_e, P_e)) is whole
    on every rank."""
    n = require_axis(mesh, axis)
    T = x.shape[0]
    E = w_router.shape[-1]
    if T % n != 0:
        raise ValueError(f"tokens {T} not divisible by {axis}={n}")
    if E % n != 0:
        raise ValueError(f"experts {E} not divisible by {axis}={n}")
    if w_gate.shape[0] == E and n > 1:
        w_gate, w_up, w_down = (split_to(w, mesh, axis, 0) for w in (w_gate, w_up, w_down))
    elif w_gate.shape[0] != E // n:
        raise ValueError(f"expert weights hold {w_gate.shape[0]} experts: expected {E} or "
                         f"this rank's {E // n}")
    cap = capacity or capacity_for(T // n, E, top_k, capacity_factor)
    # each rank routes only its group with the replicated router: backward
    # sums the groups' gradients
    y, f, p = moe_ffn_ep_sharded(
        split_to(x, mesh, axis, 0), copy_to(w_router, mesh, axis), w_gate, w_up, w_down, mesh,
        axis=axis, n_experts=E, top_k=top_k, capacity=cap,
    )
    out = gather_from(y, mesh, axis, 0)
    return (out, f, p) if return_stats else out
