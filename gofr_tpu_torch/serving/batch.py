"""Fixed-shape device functions of the continuous-batching engine (port of
``gofr_tpu/serving/batch.py``: the dense slot cache and the paged pools,
each over bf16 and int8 K/V).

The decode hot loop keeps the host out of the block: sampling and the
stop-condition evaluation run on the device inside the N-step block
(``decode_block`` over the dense cache, ``decode_block_paged``/``_q``
over the pools), which returns ONE packed int32 [B, steps+2] array
(``steps`` token columns, -1 past each row's stop; a done column; an
n_valid column), so the engine syncs once per N tokens. The block is a
Python loop over N steps that issues no host sync.

The unified ragged dispatch (``ragged_step``, ``ragged_step_paged``/``_q``)
runs the granted prefill chunks and then the N-step block against the
same cache, folds each row whose chunk completes its prompt into the
decode state with its first token sampled on the device, and returns the
packed [B, steps+3] array (one more column: that first token, -1
elsewhere): one host read per dispatch still.

What the reference donates is updated in place here: the cache and pools
by the prefill commit, decode and chunk steps, the decode state by
:func:`admit_decode_state` and :func:`_fold_finished_prefill`.
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
    k_slab, v_slab [L, S_bucket, Hkv, Dh]) for the commit into a slot row
    or into pages. The reference prefills a bucket-sized scratch
    ``KVCache``; the slabs here are that cache's rows, written directly
    with no copy between them."""
    last, k_slab, v_slab = llama._prefill_slabs(cfg, params, tokens, seq_len)
    return last, k_slab[:, 0], v_slab[:, 0]


def insert_slot(
    k_cache: torch.Tensor,  # [L, B, S_max, Hkv, Dh], written in place
    v_cache: torch.Tensor,
    k_slab: torch.Tensor,  # [L, S_bucket, Hkv, Dh]
    v_slab: torch.Tensor,
    slot: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Copy a prefilled slab into slot row [:, slot, :S_bucket]."""
    S = k_slab.shape[1]
    k_cache[:, slot, :S] = k_slab
    v_cache[:, slot, :S] = v_slab
    return k_cache, v_cache


def insert_slot_quantized(
    cache: llama.KVCache,  # int8 cache, written in place
    k_slab: torch.Tensor,  # [L, S_bucket, Hkv, Dh] full-width prefill slab
    v_slab: torch.Tensor,
    slot: int,
) -> llama.KVCache:
    """int8 twin of :func:`insert_slot`: the slabs quantize per vector and
    values and scales go to the slot row."""
    S = k_slab.shape[1]
    kq, ks = llama.quantize_kv(k_slab)
    vq, vs = llama.quantize_kv(v_slab)
    for field, value in zip(cache.tensors(), (kq, vq, ks, vs)):
        field[:, slot, :S] = value
    return cache


@dataclasses.dataclass
class DecodeState:
    """The per-row decode carry: everything the device needs to run N
    steps without the host. The host never reads it; results come back
    only through the packed block output.

    ``budget`` is the number of tokens the row may still emit (max_new and
    the sequence cap folded in at admission); ``stop_tok`` is the row's EOS
    id (-1 disables). ``done`` rows are frozen: they spend no budget, emit
    -1, and their KV writes go where they cannot matter: the sink past the
    dense cache's end, or the trash page. ``rng`` is the
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


def _decode_steps(
    cfg: llama.LlamaConfig,
    params: dict,
    kv: llama.KVCache | tuple,  # the dense cache, or (k_pool, v_pool, ks_pool, vs_pool)
    state: DecodeState,
    block_tables: torch.Tensor | None,  # paged pools only
    active: torch.Tensor,
    steps: int,
) -> tuple[torch.Tensor, DecodeState]:
    """``steps`` fused decode + sample + stop-eval iterations: (tokens
    [B, steps], state). Frozen rows' appends go to the trash page, or on
    the dense cache to length ``S_max + 1``, whose write goes to the sink:
    position 0 would corrupt the live prompt K/V of a row frozen
    mid-chunked-prefill."""
    toks = []
    for _ in range(steps):
        live = active & ~state.done
        if isinstance(kv, llama.KVCache):
            step_len = torch.where(live, state.seq_len + 1, kv.max_len + 1)
            logits, _ = llama.decode_step(cfg, params, state.last_token, kv, step_len)
        else:
            step_len = torch.where(live, state.seq_len + 1, torch.ones_like(state.seq_len))
            if kv[2] is None:
                logits, _, _ = llama.decode_step_paged(
                    cfg, params, state.last_token, kv[0], kv[1], block_tables, step_len, live
                )
            else:
                logits = llama.decode_step_paged_q(
                    cfg, params, state.last_token, *kv, block_tables, step_len, live
                )[0]
        state, out = _block_step(state, active, logits)
        toks.append(out)
    if not toks:
        return torch.empty((active.shape[0], 0), dtype=torch.int64, device=active.device), state
    return torch.stack(toks, dim=1), state


def decode_block(
    cfg: llama.LlamaConfig,
    params: dict,
    cache: llama.KVCache,  # bf16 or int8, updated in place
    state: DecodeState,
    active: torch.Tensor,  # [B] bool: rows the host dispatched this block
    steps: int,
) -> tuple[torch.Tensor, llama.KVCache, DecodeState]:
    """``steps`` fused decode + sample + stop-eval iterations over the
    dense slot cache with no host sync. A row that stops mid-block freezes:
    its appends go to the sink and its remaining columns are -1. Returns
    (packed [B, steps+2], cache, state)."""
    toks, state = _decode_steps(cfg, params, cache, state, None, active, steps)
    return _pack_block(toks, state.done, active), cache, state


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
    toks, state = _decode_steps(
        cfg, params, (k_pool, v_pool, None, None), state, block_tables, active, steps
    )
    return _pack_block(toks, state.done, active), k_pool, v_pool, state


def decode_block_paged_q(
    cfg: llama.LlamaConfig,
    params: dict,
    k_pool: torch.Tensor,  # int8, updated in place
    v_pool: torch.Tensor,
    ks_pool: torch.Tensor,  # f32 scales, updated in place
    vs_pool: torch.Tensor,
    state: DecodeState,
    block_tables: torch.Tensor,
    active: torch.Tensor,
    steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """int8 twin of :func:`decode_block_paged`: (packed, k_pool, v_pool,
    ks_pool, vs_pool, state)."""
    toks, state = _decode_steps(
        cfg, params, (k_pool, v_pool, ks_pool, vs_pool), state, block_tables, active, steps
    )
    return _pack_block(toks, state.done, active), k_pool, v_pool, ks_pool, vs_pool, state


# ------------------------------------------------- unified ragged dispatch
#
# One dispatch runs the granted PREFILL CHUNKS (the next <= C prompt tokens
# of each partially prefilled row, written into the same page pool decode
# reads) and then an N-step DECODE BLOCK, and returns ONE packed array. A
# row whose chunk completes its prompt gets its first token sampled on the
# device, with a generator seeded as the monolithic path seeds it, and is
# folded into the decode state in the same dispatch.


def _fold_finished_prefill(
    st: DecodeState,  # updated in place (the reference donates it)
    last_logits: torch.Tensor,  # [K, V] at each chunk row's last chunk position
    rows: torch.Tensor,  # [K] int64 slots of the chunk rows
    finish: torch.Tensor,  # [K] bool: this chunk completes the prompt
    new_len: torch.Tensor,  # [K] resident length after the chunk
    budgets: torch.Tensor,  # [K] tokens the row may emit AFTER the first
    stops: torch.Tensor,  # [K] stop id (-1 disables)
    temps: torch.Tensor,  # [K]
    topks: torch.Tensor,  # [K]
    topps: torch.Tensor,  # [K]
    seeds: list[int],  # [K] first-token generator seeds
) -> tuple[DecodeState, torch.Tensor]:
    """Sample first tokens for the chunk rows and fold those whose prompt
    just finished into the decode state (LoRA is not ported: the adapter
    column is 0). Each row draws from a fresh generator seeded with its
    request's seed, exactly as the monolithic prefill draws, so a request
    samples the same first token on either route. Returns (state, first
    [K] with -1 on rows that did not finish)."""
    dev = last_logits.device
    sampled = torch.cat([
        sample_logits(
            last_logits[i:i + 1], torch.Generator(device=dev).manual_seed(int(seed)),
            temperature=temps[i], top_k=topks[i], top_p=topps[i],
        )
        for i, seed in enumerate(seeds)
    ])
    done_f = (sampled == stops) | (budgets <= 0)

    def fold(field: torch.Tensor, value: torch.Tensor) -> None:
        field[rows] = torch.where(finish, value.to(field.dtype), field[rows])

    fold(st.last_token, sampled)
    fold(st.seq_len, new_len)
    fold(st.done, done_f)
    fold(st.budget, budgets)
    fold(st.stop_tok, stops)
    fold(st.temperature, temps)
    fold(st.top_k, topks)
    fold(st.top_p, topps)
    fold(st.adapter, torch.zeros_like(rows))
    return st, torch.where(finish, sampled, torch.full_like(sampled, -1))


def _pack_ragged(toks: torch.Tensor, done: torch.Tensor, active: torch.Tensor,
                 first: torch.Tensor) -> torch.Tensor:
    """:func:`_pack_block` plus one trailing column: the first token
    sampled on the device for rows whose prefill finished in this dispatch
    (-1 elsewhere). Layout [B, steps+3]: tokens | done | n_valid | first."""
    return torch.cat([_pack_block(toks, done, active), first[:, None].to(torch.int32)], dim=1)


def _ragged_step(
    cfg: llama.LlamaConfig,
    params: dict,
    kv: llama.KVCache | tuple,  # the dense cache, or the paged pools
    state: DecodeState,
    block_tables: torch.Tensor | None,  # [B, M] covers chunk AND block writes (paged)
    chunk: torch.Tensor,  # [B, C] next prompt tokens (-1 past each grant)
    chunk_start: torch.Tensor,  # [B] resident length before the chunk
    chunk_rows: torch.Tensor,  # [K] int64 slots chunking now (distinct)
    kv_capacity: torch.Tensor | None,  # [B] tokens covered by owned pages (paged)
    finish: torch.Tensor,  # [B] bool: the chunk completes the prompt
    new_len: torch.Tensor,  # [B] resident length after the chunk
    budgets: torch.Tensor,  # [B] decode budget once admitted
    stops: torch.Tensor,  # [B]
    temps: torch.Tensor,  # [B]
    topks: torch.Tensor,  # [B]
    topps: torch.Tensor,  # [B]
    seeds: list[int],  # [K] first-token seeds of the chunk rows
    decode_active: torch.Tensor,  # [B] bool: rows decoding in this block
    steps: int,
) -> tuple[torch.Tensor, torch.Tensor, DecodeState]:
    """The body of :func:`ragged_step` and :func:`ragged_step_paged` and
    its int8 twin.

    The reference runs the chunk forward over all B rows of [B, C] and
    sends the writes of the rows that are not chunking past the dense
    cache's end or to the trash page; here it runs over the K chunk rows
    alone, gathered by ``chunk_rows``, and their writes land in place in
    the shared cache or pools. Rows are independent in the forward (per-row
    rows or tables, offsets and masks), the other rows' writes were dropped
    and their logits never read, so the packed output is the same
    (``tests/test_torch_ragged.py`` and ``tests/test_torch_dense.py`` hold
    it to the reference's)."""
    rows = chunk_rows
    K = rows.shape[0]
    C = chunk.shape[1]
    start = chunk_start[rows]
    if isinstance(kv, llama.KVCache):
        x = llama._dense_chunk_forward(cfg, params, chunk[rows], kv, rows, start)
    else:
        x = llama._chunk_forward(
            cfg, params, chunk[rows], kv, block_tables[rows], start,
            torch.ones(K, dtype=torch.bool, device=chunk.device), kv_capacity[rows],
        )
    # the lm_head only where a row's prompt ends in this chunk: [K, C, V]
    # logits to keep one position per row would waste 2*K*C*D*V FLOPs
    pos = (new_len[rows].long() - start.long() - 1).clamp(0, C - 1)
    last_h = x[torch.arange(K, device=x.device), pos][:, None]  # [K, 1, D]
    last_logits = llama._logits(cfg, params, last_h)[:, 0]  # [K, V]
    state, first_k = _fold_finished_prefill(
        state, last_logits, rows, finish[rows], new_len[rows], budgets[rows], stops[rows],
        temps[rows], topks[rows], topps[rows], seeds,
    )
    first = torch.full((chunk.shape[0],), -1, dtype=first_k.dtype, device=first_k.device)
    first[rows] = first_k
    toks, state = _decode_steps(cfg, params, kv, state, block_tables, decode_active, steps)
    return _pack_ragged(toks, state.done, decode_active, first), last_logits, state


def ragged_step(
    cfg: llama.LlamaConfig,
    params: dict,
    cache: llama.KVCache,  # bf16 or int8, updated in place
    state: DecodeState,  # updated in place
    chunk: torch.Tensor,  # [B, C]
    chunk_start: torch.Tensor,  # [B]
    chunk_rows: torch.Tensor,  # [K] int64 slots chunking now (distinct)
    finish: torch.Tensor,
    new_len: torch.Tensor,
    budgets: torch.Tensor,
    stops: torch.Tensor,
    temps: torch.Tensor,
    topks: torch.Tensor,
    topps: torch.Tensor,
    seeds: list[int],
    decode_active: torch.Tensor,
    steps: int,
) -> tuple[torch.Tensor, torch.Tensor, llama.KVCache, DecodeState]:
    """Unified ragged dispatch over the dense slot cache: the chunk forward
    of the chunk rows (K/V in place at [layer, rows, start:start+C], a
    tail past ``S_max`` to the sink), the first-token fold of the rows that
    finish, then the N-step decode block, with no host sync. Returns
    (packed [B, steps+3], last_logits [K, V], cache, state). Against the
    reference, as in :func:`ragged_step_paged`: ``chunk_rows`` and
    ``seeds`` in place of the rows whose start is ``max_seq_len`` and of
    ``rids`` with ``rng_root``, and ``last_logits`` of the chunk rows
    only."""
    packed, last_logits, state = _ragged_step(
        cfg, params, cache, state, None, chunk, chunk_start, chunk_rows, None, finish, new_len,
        budgets, stops, temps, topks, topps, seeds, decode_active, steps,
    )
    return packed, last_logits, cache, state


def ragged_step_paged(
    cfg: llama.LlamaConfig,
    params: dict,
    k_pool: torch.Tensor,  # updated in place
    v_pool: torch.Tensor,
    state: DecodeState,  # updated in place
    block_tables: torch.Tensor,
    chunk: torch.Tensor,
    chunk_start: torch.Tensor,
    chunk_rows: torch.Tensor,
    kv_capacity: torch.Tensor,
    finish: torch.Tensor,
    new_len: torch.Tensor,
    budgets: torch.Tensor,
    stops: torch.Tensor,
    temps: torch.Tensor,
    topks: torch.Tensor,
    topps: torch.Tensor,
    seeds: list[int],
    decode_active: torch.Tensor,
    steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """Unified ragged dispatch over bf16 pools: the chunk forward of the
    chunk rows, the first-token fold of the rows that finish, then the
    N-step decode block, with no host sync. Returns (packed [B, steps+3],
    last_logits [K, V], k_pool, v_pool, state). Against the reference,
    the rows chunking now come as ``chunk_rows`` indices (the reference's
    ``chunk_active`` mask) and their first-token generators as ``seeds``
    (its ``rids`` with ``rng_root``); ``last_logits`` has the chunk rows
    only."""
    packed, last_logits, state = _ragged_step(
        cfg, params, (k_pool, v_pool, None, None), state, block_tables, chunk, chunk_start,
        chunk_rows, kv_capacity, finish, new_len, budgets, stops, temps, topks, topps, seeds,
        decode_active, steps,
    )
    return packed, last_logits, k_pool, v_pool, state


def ragged_step_paged_q(
    cfg: llama.LlamaConfig,
    params: dict,
    k_pool: torch.Tensor,  # int8, updated in place
    v_pool: torch.Tensor,
    ks_pool: torch.Tensor,  # f32 scales, updated in place
    vs_pool: torch.Tensor,
    state: DecodeState,
    block_tables: torch.Tensor,
    chunk: torch.Tensor,
    chunk_start: torch.Tensor,
    chunk_rows: torch.Tensor,
    kv_capacity: torch.Tensor,
    finish: torch.Tensor,
    new_len: torch.Tensor,
    budgets: torch.Tensor,
    stops: torch.Tensor,
    temps: torch.Tensor,
    topks: torch.Tensor,
    topps: torch.Tensor,
    seeds: list[int],
    decode_active: torch.Tensor,
    steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, DecodeState]:
    """int8 twin of :func:`ragged_step_paged`: (packed, last_logits, k_pool,
    v_pool, ks_pool, vs_pool, state)."""
    packed, last_logits, state = _ragged_step(
        cfg, params, (k_pool, v_pool, ks_pool, vs_pool), state, block_tables, chunk,
        chunk_start, chunk_rows, kv_capacity, finish, new_len, budgets, stops, temps, topks,
        topps, seeds, decode_active, steps,
    )
    return packed, last_logits, k_pool, v_pool, ks_pool, vs_pool, state


def pad_bucket(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= length (prompt padding)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
