"""Fixed-shape device functions of the continuous-batching engine (port of
``gofr_tpu/serving/batch.py``, the paged bf16 monolithic-prefill path).

The decode hot loop keeps the host out of the block: sampling and the
stop-condition evaluation run on the device inside the N-step block
(``decode_block_paged``), which returns ONE packed int32 [B, steps+2] array
(``steps`` token columns, -1 past each row's stop; a done column; an
n_valid column), so the engine syncs once per N tokens. The block is a
Python loop over N steps that issues no host sync.

What the reference donates is updated in place here: the pools by
``decode_step_paged``, the decode state by :func:`admit_decode_state`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch._device import to_device
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.sampling import sample_logits, stop_eval


def prefill_compute(
    cfg: llama.LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [1, S_bucket] right-padded
    seq_len: torch.Tensor,  # [1]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill without a persistent cache: (last_logits [1, V] f32,
    k_slab, v_slab [L, S_bucket, Hkv, Dh]) for the scatter into pages."""
    last, k_slab, v_slab = llama.prefill(cfg, params, tokens, seq_len)
    return last, k_slab[:, 0], v_slab[:, 0]


@dataclasses.dataclass
class DecodeState:
    """The per-row decode carry: everything the device needs to run N
    steps without the host. The host never reads it; results come back
    only through the packed block output.

    ``budget`` is the number of tokens the row may still emit (max_new and
    the sequence cap folded in at admission); ``stop_tok`` is the row's EOS
    id (-1 disables). ``done`` rows are frozen: they spend no budget, emit
    -1, and their KV writes go to the trash page. ``rng`` is the
    ``torch.Generator`` the block's draws come from. ``adapter`` is the
    LoRA table slot (0 = base) the reference carries; the port has no LoRA
    yet and keeps it 0."""

    last_token: torch.Tensor  # [B] int64
    seq_len: torch.Tensor  # [B] int32, tokens RESIDENT in KV (incl. prompt)
    done: torch.Tensor  # [B] bool
    budget: torch.Tensor  # [B] int32
    stop_tok: torch.Tensor  # [B] int64
    temperature: torch.Tensor  # [B] f32
    top_k: torch.Tensor  # [B] int64
    top_p: torch.Tensor  # [B] f32
    rng: torch.Generator
    adapter: torch.Tensor | None = None  # [B] int32


def make_decode_state(
    last_token: Any, seq_len: Any, done: Any, budget: Any, stop_tok: Any,
    temperature: Any, top_k: Any, top_p: Any, rng: torch.Generator,
    adapter: Any = None, *, device: torch.device,
) -> DecodeState:
    """Upload a fresh DecodeState from host (numpy) mirrors: the cold path
    (first dispatch, rebuild after a failure)."""
    if adapter is None:
        adapter = np.zeros(np.asarray(last_token).shape[0], np.int32)

    def up(x: Any, dtype: Any) -> torch.Tensor:
        return to_device(np.asarray(x, dtype), device)

    return DecodeState(
        up(last_token, np.int64), up(seq_len, np.int32), up(done, np.bool_),
        up(budget, np.int32), up(stop_tok, np.int64), up(temperature, np.float32),
        up(top_k, np.int64), up(top_p, np.float32), rng, up(adapter, np.int32),
    )


def admit_decode_state(
    state: DecodeState,  # updated in place (the reference donates it)
    slots: torch.Tensor,  # [K] int64
    tokens: torch.Tensor,  # [K] each slot's prefill-sampled token
    lens: torch.Tensor,  # [K] resident prompt length
    budgets: torch.Tensor,  # [K]
    stops: torch.Tensor,  # [K]
    temps: torch.Tensor,  # [K] f32
    topks: torch.Tensor,  # [K]
    topps: torch.Tensor,  # [K] f32
    adapters: torch.Tensor,  # [K]
) -> DecodeState:
    """Fold freshly prefilled slots into the decode state: un-done, new
    token, length, budget, stop id and sampling params."""
    state.last_token[slots] = tokens.to(state.last_token.dtype)
    state.seq_len[slots] = lens.to(state.seq_len.dtype)
    state.done[slots] = False
    state.budget[slots] = budgets.to(state.budget.dtype)
    state.stop_tok[slots] = stops.to(state.stop_tok.dtype)
    state.temperature[slots] = temps.to(state.temperature.dtype)
    state.top_k[slots] = topks.to(state.top_k.dtype)
    state.top_p[slots] = topps.to(state.top_p.dtype)
    state.adapter[slots] = adapters.to(state.adapter.dtype)
    return state


def _pack_block(toks: torch.Tensor, done: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """One int32 [B, steps+2] array: columns [0, steps) the sampled tokens
    (-1 past each row's stop), column ``steps`` the done flag, column
    ``steps+1`` the per-row valid count."""
    n_valid = (toks >= 0).sum(dim=1, dtype=torch.int32)
    return torch.cat(
        [toks.to(torch.int32), (done & active)[:, None].to(torch.int32), n_valid[:, None]],
        dim=1,
    )


def _block_step(st: DecodeState, active: torch.Tensor, logits: torch.Tensor) -> tuple[DecodeState, torch.Tensor]:
    """Per-step tail of the block: sample with each row's own params,
    evaluate the stop conditions, advance the carry. Frozen (done or
    inactive) rows keep their token and length and emit -1."""
    live = active & ~st.done
    nxt = sample_logits(
        logits, st.rng, temperature=st.temperature, top_k=st.top_k, top_p=st.top_p
    )
    nxt = torch.where(live, nxt, st.last_token)
    done = st.done | (live & stop_eval(nxt, st.stop_tok, st.budget))
    new_st = DecodeState(
        nxt,
        torch.where(live, st.seq_len + 1, st.seq_len),
        done,
        torch.where(live, st.budget - 1, st.budget),
        st.stop_tok, st.temperature, st.top_k, st.top_p, st.rng, st.adapter,
    )
    return new_st, torch.where(live, nxt, torch.full_like(nxt, -1))


def decode_block_paged(
    cfg: llama.LlamaConfig,
    params: dict,
    k_pool: torch.Tensor,  # [L, N_pages+1, Hkv, page, Dh], updated in place (+1: trash)
    v_pool: torch.Tensor,
    state: DecodeState,
    block_tables: torch.Tensor,  # [B, M] int32, covers the whole block's writes
    active: torch.Tensor,  # [B] bool
    steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """``steps`` fused decode + sample + stop-eval iterations with no host
    sync. A row that stops mid-block freezes: its appends go to the trash
    page and its remaining columns are -1. Returns (packed [B, steps+2],
    k_pool, v_pool, state); the packed array is the block's only value the
    host reads."""
    toks = []
    for _ in range(steps):
        live = active & ~state.done
        step_len = torch.where(live, state.seq_len + 1, torch.ones_like(state.seq_len))
        logits, k_pool, v_pool = llama.decode_step_paged(
            cfg, params, state.last_token, k_pool, v_pool, block_tables, step_len, live
        )
        state, out = _block_step(state, active, logits)
        toks.append(out)
    packed = _pack_block(torch.stack(toks, dim=1), state.done, active)
    return packed, k_pool, v_pool, state


def pad_bucket(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (prompt padding)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
