"""Llama-family decoder (port of ``gofr_tpu/models/llama.py``, serving half).

Plain functions over a params dict of tensors, with the JAX package's
layouts: stacked layer weights ``[L, ...]`` (kept stacked; a layer is a
view ``w[l]``), ``[B, S, H, D]`` activations, paged pools
``[L, N+1, Hkv, page, Dh]`` whose last page is the trash page. bf16
weights and activations with f32 norms, softmax and logits.

What the JAX package donates is updated in place here: ``decode_step_paged``
and ``decode_chunk_paged`` (and their int8 twins) write K/V, and for int8
pools its scales, into the pools they are given and return them.

Kept: ``LlamaConfig``, ``init_params``, ``prefill`` into a scratch slab,
per-vector int8 ``quantize_kv``/``dequantize_kv``, ``decode_step_paged``
and ``decode_step_paged_q`` (bf16 and int8 pools), and the chunk forward
``decode_chunk_paged``/``decode_chunk_paged_q`` that chunked prefill runs.
Waiting for later slices: weight-only int8, the dense ``KVCache`` decode
path and its ``decode_chunk``, ``forward``, tied embeddings and context
parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_q
from gofr_tpu_torch.ops.rope import apply_rope, rope_table


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw: Any) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw: Any) -> "LlamaConfig":
        """Test-size config: runs on the CPU in milliseconds."""
        defaults = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random params with stacked layers [L, ...], made on ``device`` (the
    card by default) in the model dtype, so an 8B model never exists on the
    host. ``generator`` must live on that device; None seeds one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def winit(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=dev, dtype=cfg.dtype)
        return w.div_(math.sqrt(fan_in))

    params: dict = {
        "embedding": winit((cfg.vocab_size, D), D),
        "layers": {
            "wq": winit((L, D, H * Dh), D),
            "wk": winit((L, D, Hkv * Dh), D),
            "wv": winit((L, D, Hkv * Dh), D),
            "wo": winit((L, H * Dh, D), H * Dh),
            "w_gate": winit((L, D, Fd), D),
            "w_up": winit((L, D, Fd), D),
            "w_down": winit((L, Fd, D), Fd),
            "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": winit((D, cfg.vocab_size), D),
    }
    return params


def layer_params(params: dict, layer: int) -> dict:
    """Layer ``layer``'s weights as views into the stacked leaves."""
    return {name: w[layer] for name, w in params["layers"].items()}


_INV_127 = 1.0 / 127.0  # a Python float: the product rounds it to f32 first


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector (last-dim) absmax int8 quantization: [..., Dh] ->
    (int8 [..., Dh], f32 scale [...]). Bit-identical to the reference as
    its served paths run it, under ``jit``: f32 first; the absmax times
    f32(1/127), the product XLA makes of the division by the constant 127;
    a true division of x by the scale (not a product with its reciprocal);
    ``torch.round`` rounds half to even like ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * _INV_127, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection matmul in the activation dtype (f32 accumulation inside
    the GEMM), as ``x @ w`` is in the reference."""
    return x @ w


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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


def _qkv(
    cfg: LlamaConfig,
    x: torch.Tensor,  # [B, S, D]
    lp: dict,
    sin: torch.Tensor,
    cos: torch.Tensor,
    positions: torch.Tensor,  # [B, S]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared layer preamble: attn-norm + QKV projections + RoPE.
    Returns (h_normed, q, k, v), each of q/k/v contiguous."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _mm(h, lp["wq"]).reshape(B, S, H, Dh)
    k = _mm(h, lp["wk"]).reshape(B, S, Hkv, Dh)
    v = _mm(h, lp["wv"]).reshape(B, S, Hkv, Dh)
    q = apply_rope(q, positions, sin, cos)
    k = apply_rope(k, positions, sin, cos)
    return h, q, k, v


def _attn_mlp_epilogue(
    cfg: LlamaConfig, x: torch.Tensor, lp: dict, attn: torch.Tensor
) -> torch.Tensor:
    """Shared layer epilogue: attention output projection + SwiGLU MLP,
    the SiLU gate in f32."""
    B, S, _ = x.shape
    x = x + _mm(attn.reshape(B, S, cfg.n_heads * cfg.head_dim), lp["wo"])
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(_mm(h, lp["w_gate"]).float()).to(h.dtype)
    return x + _mm(gate * _mm(h, lp["w_up"]), lp["w_down"])


def _logits(cfg: LlamaConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + lm_head, f32 logits [..., V]."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _matmul_f32(x, params["lm_head"])


def _embed(cfg: LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens].to(cfg.dtype)


def prefill(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, S] right-padded
    seq_lens: torch.Tensor,  # [B] true lengths (int32)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill into a fresh scratch slab: returns (last-token logits [B, V]
    f32, k_slab, v_slab [L, B, S, Hkv, Dh]). Attention is the flash kernel
    (its plain version on the CPU); positions past ``seq_lens`` still
    attend to the valid keys and their K/V is masked at every later read."""
    B, S = tokens.shape
    dev = tokens.device
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    sin, cos = rope_table(cfg.max_seq_len, Dh, cfg.rope_theta, dev)
    k_slab = torch.empty((L, B, S, Hkv, Dh), dtype=cfg.dtype, device=dev)
    v_slab = torch.empty_like(k_slab)
    kv_len = seq_lens.to(device=dev, dtype=torch.int32)
    for layer in range(L):
        lp = layer_params(params, layer)
        _, q, k, v = _qkv(cfg, x, lp, sin, cos, positions)
        k_slab[layer] = k
        v_slab[layer] = v
        attn = flash_attention(q, k, v, kv_len, causal=True)
        x = _attn_mlp_epilogue(cfg, x, lp, attn)
    # the last valid position's hidden state BEFORE the lm_head: [B, S, V]
    # logits only to keep one position would waste 2*B*S*D*V FLOPs
    last_idx = (kv_len.long() - 1).clamp(0, S - 1)
    last_h = x[torch.arange(B, device=dev), last_idx][:, None]  # [B, 1, D]
    return _logits(cfg, params, last_h)[:, 0], k_slab, v_slab


def _write_kv(
    kc: torch.Tensor,  # [N+1, Hkv, page, Dh] one layer's pool, written in place
    vc: torch.Tensor,
    ksc: torch.Tensor | None,  # int8 pools: [N+1, Hkv, page, 1] f32 scales
    vsc: torch.Tensor | None,
    pages: torch.Tensor,  # [...] page per written position
    offsets: torch.Tensor,  # [...] offset in that page
    k: torch.Tensor,  # [..., Hkv, Dh]
    v: torch.Tensor,
) -> None:
    """Scatter K/V into one layer's pools at (page, offset); into int8
    pools the values quantize first and their scales go to the same
    (page, offset), so a position sent to the trash page sends its scale
    there too."""
    if ksc is None:
        kc[pages, :, offsets] = k
        vc[pages, :, offsets] = v
        return
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    kc[pages, :, offsets] = kq
    vc[pages, :, offsets] = vq
    ksc[pages, :, offsets, 0] = ks
    vsc[pages, :, offsets, 0] = vs


def _decode_step(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,
    pools: tuple,  # (k_pool, v_pool, ks_pool, vs_pool); scales None for bf16
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    active: torch.Tensor,
) -> torch.Tensor:
    """The body of :func:`decode_step_paged` and :func:`decode_step_paged_q`:
    returns the logits, the pools written in place."""
    k_pool, v_pool, ks_pool, vs_pool = pools
    B = tokens.shape[0]
    dev = tokens.device
    page = k_pool.shape[3]
    trash_page = k_pool.shape[1] - 1
    M = block_tables.shape[1]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = _embed(cfg, params, tokens)[:, None, :]  # [B, 1, D]
    pos = (seq_lens.long() - 1).clamp_min(0)  # [B]
    positions = pos[:, None]
    sin, cos = rope_table(cfg.max_seq_len, Dh, cfg.rope_theta, dev)
    rows = torch.arange(B, device=dev)
    # every index is masked explicitly: the table column is clamped into
    # the table, and inactive rows aim at offset 0 of the trash page
    col = (pos // page).clamp_max(M - 1)
    pages = torch.where(active, block_tables[rows, col].long(), trash_page)
    offsets = torch.where(active, pos % page, 0)
    lens = seq_lens.to(torch.int32)
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        hn = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _mm(hn, lp["wq"]).reshape(B, 1, H, Dh)
        k = _mm(hn, lp["wk"]).reshape(B, 1, Hkv, Dh)
        v = _mm(hn, lp["wv"]).reshape(B, 1, Hkv, Dh)
        q = apply_rope(q, positions, sin, cos)[:, 0].contiguous()  # [B, H, Dh]
        k = apply_rope(k, positions, sin, cos)[:, 0]  # [B, Hkv, Dh]
        kc, vc = k_pool[layer], v_pool[layer]  # views: [N+1, Hkv, page, Dh]
        if ks_pool is None:
            _write_kv(kc, vc, None, None, pages, offsets, k, v[:, 0])
            attn = paged_decode_attention(q, kc, vc, block_tables, lens)
        else:
            ksc, vsc = ks_pool[layer], vs_pool[layer]  # [N+1, Hkv, page, 1]
            _write_kv(kc, vc, ksc, vsc, pages, offsets, k, v[:, 0])
            attn = paged_decode_attention_q(q, kc, vc, ksc, vsc, block_tables, lens)
        x = _attn_mlp_epilogue(cfg, x, lp, attn[:, None])
    return _logits(cfg, params, x)[:, 0]


def decode_step_paged(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B] last sampled token per row
    k_pool: torch.Tensor,  # [L, N_pages+1, Hkv, page, Dh], updated in place
    v_pool: torch.Tensor,  # updated in place
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] int32, length INCLUDING this token's position
    active: torch.Tensor,  # [B] bool: inactive rows must not write live pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the paged pool: writes this step's K/V into each
    active row's page slot (in place: the pools are the reference's donated
    buffers) and attends through the block tables with the paged kernel.
    Inactive rows write into the pool's LAST page, the trash page, so no
    two rows' writes meet on a live page; their output is ignored. Returns
    (logits [B, V] f32, k_pool, v_pool). Issues no host sync."""
    logits = _decode_step(
        cfg, params, tokens, (k_pool, v_pool, None, None), block_tables, seq_lens, active
    )
    return logits, k_pool, v_pool


def decode_step_paged_q(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B]
    k_pool: torch.Tensor,  # [L, N_pages+1, Hkv, page, Dh] int8, updated in place
    v_pool: torch.Tensor,
    ks_pool: torch.Tensor,  # [L, N_pages+1, Hkv, page, 1] f32, updated in place
    vs_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    seq_lens: torch.Tensor,  # [B] length INCLUDING this token's position
    active: torch.Tensor,  # [B] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`decode_step_paged`: this step's K/V quantize
    (per-vector absmax) before the page scatter, values and scales alike
    (frozen rows send both to the trash page), and attention reads the
    pools through the dequantizing kernel. Returns (logits, k_pool, v_pool,
    ks_pool, vs_pool)."""
    logits = _decode_step(
        cfg, params, tokens, (k_pool, v_pool, ks_pool, vs_pool), block_tables, seq_lens, active
    )
    return logits, k_pool, v_pool, ks_pool, vs_pool


def _paged_chunk_targets(
    k_pool: torch.Tensor,  # [L, N+1, Hkv, page, Dh]
    block_tables: torch.Tensor,  # [B, M]
    positions: torch.Tensor,  # [B, T] absolute write positions
    active: torch.Tensor,  # [B] bool
    kv_capacity: torch.Tensor,  # [B] tokens covered by OWNED pages
) -> tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) targets of a chunk write. Positions past a row's
    owned capacity, and every position of an inactive row, go to the
    trash page: table entries past the owned prefix read 0, and page 0 is
    live, so an unmasked overflow write would corrupt another sequence."""
    page = k_pool.shape[3]
    trash = k_pool.shape[1] - 1
    M = block_tables.shape[1]
    valid = active[:, None] & (positions < kv_capacity.long()[:, None])
    col = (positions // page).clamp_max(M - 1)
    pages = torch.where(valid, torch.gather(block_tables.long(), 1, col), trash)
    offsets = torch.where(valid, positions % page, 0)
    return pages, offsets


def _paged_gather(
    pool: torch.Tensor,  # [N+1, Hkv, page, Dh] one layer's pool
    block_tables: torch.Tensor,  # [B, M]
    scale: torch.Tensor | None = None,  # int8 pools: [N+1, Hkv, page, 1]
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Each row's pages as contiguous [B, M*page, Hkv, Dh] for the chunk
    attention; int8 pages dequantize to ``dtype`` (the plain gather path,
    as in the reference: chunks are a small share of the traffic)."""
    tables = block_tables.long()
    g = pool[tables]  # [B, M, Hkv, page, Dh]
    if scale is not None:
        g = (g.float() * scale[tables]).to(dtype)
    B, M, Hkv, page, Dh = g.shape
    return g.transpose(2, 3).reshape(B, M * page, Hkv, Dh)


def _chunk_forward(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, T] chunk tokens (-1 pads the ragged tail)
    pools: tuple,  # (k_pool, v_pool, ks_pool, vs_pool); scales None for bf16
    block_tables: torch.Tensor,  # [B, M]
    start_len: torch.Tensor,  # [B] committed length BEFORE the chunk
    active: torch.Tensor,  # [B] bool
    kv_capacity: torch.Tensor,  # [B] tokens covered by owned pages
) -> torch.Tensor:
    """The chunk forward of :func:`decode_chunk_paged` up to the final
    hidden state [B, T, D]: writes the chunk's K/V through the block tables
    (in place; overflow and inactive rows to the trash page) and attends
    over each row's gathered pages with per-row ``q_offset``. The serving
    path applies the lm_head only at each row's last prompt position."""
    k_pool, v_pool, ks_pool, vs_pool = pools
    B, T = tokens.shape
    dev = tokens.device
    start = start_len.long()
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    pages, offsets = _paged_chunk_targets(k_pool, block_tables, positions, active, kv_capacity)
    x = _embed(cfg, params, tokens.clamp_min(0))
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    # pad positions of a final ragged chunk may run past the rope table;
    # the reference's gather clamps them, their outputs are never read
    rope_pos = positions.clamp_max(cfg.max_seq_len - 1)
    kv_len = start + T
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _qkv(cfg, x, lp, sin, cos, rope_pos)
        kc, vc = k_pool[layer], v_pool[layer]
        ksc = vsc = None
        if ks_pool is not None:
            ksc, vsc = ks_pool[layer], vs_pool[layer]
        _write_kv(kc, vc, ksc, vsc, pages, offsets, k, v)
        kg = _paged_gather(kc, block_tables, ksc, cfg.dtype)
        vg = _paged_gather(vc, block_tables, vsc, cfg.dtype)
        attn = attention(q, kg, vg, causal=True, q_offset=start, kv_len=kv_len)
        x = _attn_mlp_epilogue(cfg, x, lp, attn)
    return x


def decode_chunk_paged(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, T]
    k_pool: torch.Tensor,  # [L, N+1, Hkv, page, Dh], updated in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M]
    start_len: torch.Tensor,  # [B] committed length BEFORE the chunk
    active: torch.Tensor,  # [B]
    kv_capacity: torch.Tensor,  # [B] tokens covered by owned pages
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run T tokens per row against the page pool in one call (chunked
    prefill): K/V written through the block tables, attention over the
    gathered pages. Returns (logits [B, T, V] f32, k_pool, v_pool)."""
    x = _chunk_forward(cfg, params, tokens, (k_pool, v_pool, None, None), block_tables,
                      start_len, active, kv_capacity)
    return _logits(cfg, params, x), k_pool, v_pool


def decode_chunk_paged_q(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, T]
    k_pool: torch.Tensor,  # int8, updated in place
    v_pool: torch.Tensor,
    ks_pool: torch.Tensor,  # f32 scales, updated in place
    vs_pool: torch.Tensor,
    block_tables: torch.Tensor,
    start_len: torch.Tensor,
    active: torch.Tensor,
    kv_capacity: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`decode_chunk_paged`: the chunk's K/V quantize
    before the scatter and the gathered pages dequantize to the model
    dtype. Returns (logits, k_pool, v_pool, ks_pool, vs_pool)."""
    x = _chunk_forward(cfg, params, tokens, (k_pool, v_pool, ks_pool, vs_pool), block_tables,
                      start_len, active, kv_capacity)
    return _logits(cfg, params, x), k_pool, v_pool, ks_pool, vs_pool
