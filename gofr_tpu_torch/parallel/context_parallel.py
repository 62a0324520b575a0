"""Context/sequence parallelism: ring attention and Ulysses all-to-all
(port of ``gofr_tpu/parallel/context_parallel.py``).

Long sequences are sharded on the ``sp`` mesh axis and attention runs
either

- **ring attention**: each rank keeps its Q shard and passes KV shards
  around the ``sp`` ring with ``ppermute``, accumulating an online
  softmax; memory per rank is O(S/n). The block update is plain PyTorch,
  as the reference's is plain XLA; or
- **Ulysses**: two tiled ``all_to_all`` reshardings (sequence to heads,
  heads to sequence) around a full-sequence causal attention on H/n heads,
  which is the flash kernel on the card (its plain version on the CPU).

The ``*_sharded`` functions take this rank's sequence shard; the
global-view ``ring_attention``/``ulysses_attention`` keep the reference's
signatures: the full tensors on every rank in, the full result on every
rank out.
"""

from __future__ import annotations

import math
import threading
from typing import Any

import torch

from gofr_tpu_torch.ops.attention import NEG_INF
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.parallel.collectives import all_to_all, gather_from, ppermute, split_to
from gofr_tpu_torch.parallel.mesh import Mesh, require_axis


def gqa_repeat(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, n_kv, D] -> [B, S, n_heads, D] by head-group broadcast."""
    n_kv = kv.shape[2]
    if n_kv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // n_kv, dim=2)


def _block_accumulate(q, k, v, acc, m, l, q_start: int, k_start: int, scale: float):
    """One online-softmax block update, GQA-native.

    q: [B,Sq,H,D]; k/v: [B,Sk,Hkv,D]; acc: [B,Sq,Hkv,G,D] f32;
    m, l: [B,Hkv,G,Sq] f32 running max / denominator.
    Positions are global: ``q_start``/``k_start`` are the absolute offsets of
    the local blocks, so the causal mask is exact across ring steps.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    dev = q.device
    q_pos = q_start + torch.arange(Sq, device=dev)
    k_pos = k_start + torch.arange(Sk, device=dev)
    mask = k_pos[None, :] <= q_pos[:, None]  # [Sq, Sk]
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=dev))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # exp(NEG_INF - NEG_INF) == 1 in a fully masked block: zero those
    # probabilities explicitly instead of trusting the subtraction
    p = torch.exp(logits - m_new[..., None]) * mask
    corr = torch.exp(m - m_new)  # [B,Hkv,G,Sq]
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    acc_new = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return acc_new, m_new, l_new


def ring_attention_sharded(
    q: torch.Tensor,  # [B, S_loc, H, D] this rank's sequence shard
    k: torch.Tensor,  # [B, S_loc, Hkv, D]
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    scale: float | None = None,
) -> torch.Tensor:
    """Causal ring attention over this rank's shard. KV blocks rotate the
    ring; block ``(i - s) mod n`` is resident at rank ``i`` on step ``s``:
    n-1 accumulate-and-rotate steps, then a final accumulate (the last
    rotation would be discarded)."""
    B, S_loc, H, D = q.shape
    Hkv = k.shape[2]
    n = require_axis(mesh, axis)
    scale = scale if scale is not None else D ** -0.5
    idx = mesh.index(axis)
    q_start = idx * S_loc
    dev = q.device
    acc = torch.zeros((B, S_loc, Hkv, H // Hkv, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, H // Hkv, S_loc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, H // Hkv, S_loc), dtype=torch.float32, device=dev)
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_blk, v_blk = k, v
    for s in range(n - 1):
        src = (idx - s) % n
        acc, m, l = _block_accumulate(q, k_blk, v_blk, acc, m, l, q_start, src * S_loc, scale)
        k_blk = ppermute(k_blk, mesh, axis, perm)
        v_blk = ppermute(v_blk, mesh, axis, perm)
    src = (idx - (n - 1)) % n
    acc, m, l = _block_accumulate(q, k_blk, v_blk, acc, m, l, q_start, src * S_loc, scale)
    out = acc / (l.permute(0, 3, 1, 2)[..., None] + 1e-30)
    return out.reshape(B, S_loc, H, D).to(q.dtype)


def _global_view(fn, q, k, v, mesh: Mesh, axis: str, scale: float | None) -> torch.Tensor:
    n = require_axis(mesh, axis)
    if q.shape[1] % n != 0:
        raise ValueError(f"seq {q.shape[1]} not divisible by {axis}={n}")
    q, k, v = (split_to(t, mesh, axis, 1) for t in (q, k, v))
    return gather_from(fn(q, k, v, mesh, axis=axis, scale=scale), mesh, axis, 1)


def ring_attention(
    q: torch.Tensor,  # [B, S, H, D] global view
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    scale: float | None = None,
) -> torch.Tensor:
    """The full q, k, v on every rank: each rank runs the ring on its
    sequence shard; the full result on every rank."""
    return _global_view(ring_attention_sharded, q, k, v, mesh, axis, scale)


def ulysses_attention_sharded(
    q: torch.Tensor,  # [B, S_loc, H, D]
    k: torch.Tensor,  # [B, S_loc, Hkv, D]
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    scale: float | None = None,
) -> torch.Tensor:
    """Ulysses: all_to_all seq→heads, full-sequence causal attention on
    H/n heads (:func:`flash_attention`), all_to_all back. Requires
    H % n == 0; KV heads are repeated only to lcm(Hkv, n) when Hkv does
    not divide, enough for an even head split (the attention contracts
    grouped queries against the unexpanded KV)."""
    H = q.shape[2]
    n = require_axis(mesh, axis)
    if H % n != 0:
        raise ValueError(f"heads {H} not divisible by {axis}={n}")
    if k.shape[2] % n != 0:
        target = math.lcm(k.shape[2], n)
        k = gqa_repeat(k, target)
        v = gqa_repeat(v, target)

    def reshard_in(x):  # [B,S_loc,h,D] -> [B,S,h/n,D]
        return all_to_all(x, mesh, axis, split_axis=2, concat_axis=1).contiguous()

    out = flash_attention(reshard_in(q), reshard_in(k), reshard_in(v), causal=True, scale=scale)
    return all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)  # -> [B,S_loc,H,D]


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "sp",
    scale: float | None = None,
) -> torch.Tensor:
    return _global_view(ulysses_attention_sharded, q, k, v, mesh, axis, scale)


# ---------------------------------------------------------------------------
# An ambient context so model code can pick up the CP mesh without threading
# it through every call (the reference's trace-time context). Per thread.

_cp_state = threading.local()


class cp_context:
    """``with cp_context(mesh, axis="sp", impl="ring"): forward(...)`` —
    layers whose config says ``attn_impl="cp"`` use this mesh/axis."""

    def __init__(self, mesh: Mesh, axis: str = "sp", impl: str = "ring") -> None:
        if impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown cp impl {impl!r}")
        self.entry = (mesh, axis, impl)

    def __enter__(self):
        if not hasattr(_cp_state, "stack"):
            _cp_state.stack = []
        _cp_state.stack.append(self.entry)
        return self

    def __exit__(self, *exc: Any):
        _cp_state.stack.pop()
        return False


def current_cp() -> tuple[Mesh, str, str] | None:
    stack = getattr(_cp_state, "stack", None)
    return stack[-1] if stack else None


def cp_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Dispatch to ring/ulysses per the ambient cp_context (global view)."""
    state = current_cp()
    if state is None:
        raise RuntimeError("attn_impl='cp' requires an enclosing cp_context(mesh)")
    mesh, axis, impl = state
    fn = ring_attention if impl == "ring" else ulysses_attention
    return fn(q, k, v, mesh, axis=axis, scale=scale)


def cp_attention_sharded(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """:func:`cp_attention` on this rank's sequence shard (the model's
    layers under ``attn_impl="cp"`` keep the shard through the layer)."""
    state = current_cp()
    if state is None:
        raise RuntimeError("attn_impl='cp' requires an enclosing cp_context(mesh)")
    mesh, axis, impl = state
    fn = ring_attention_sharded if impl == "ring" else ulysses_attention_sharded
    return fn(q, k, v, mesh, axis=axis, scale=scale)
