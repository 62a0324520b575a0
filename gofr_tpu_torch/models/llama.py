"""Llama-family decoder (port of ``gofr_tpu/models/llama.py``, serving half).

Plain functions over a params dict of tensors, with the JAX package's
layouts: stacked layer weights ``[L, ...]`` (kept stacked; a layer is a
view ``w[l]``), ``[B, S, H, D]`` activations, paged pools
``[L, N+1, Hkv, page, Dh]`` whose last page is the trash page. bf16
weights and activations with f32 norms, softmax and logits.

What the JAX package donates is updated in place here: ``decode_step_paged``
writes each step's K/V into the pools it is given and returns them.

Kept: ``LlamaConfig``, ``init_params``, ``prefill`` into a scratch slab and
``decode_step_paged``. Waiting for later slices: weight-only int8, the
dense ``KVCache`` decode path, ``decode_chunk*``, ``forward``, tied
embeddings and context parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.flash_attention import flash_attention
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.paged_attention import paged_decode_attention
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
        q = apply_rope(q, positions, sin, cos)[:, 0]  # [B, H, Dh]
        k = apply_rope(k, positions, sin, cos)[:, 0]  # [B, Hkv, Dh]
        kc, vc = k_pool[layer], v_pool[layer]  # views: [N+1, Hkv, page, Dh]
        kc[pages, :, offsets] = k
        vc[pages, :, offsets] = v[:, 0]
        attn = paged_decode_attention(q.contiguous(), kc, vc, block_tables, lens)
        x = _attn_mlp_epilogue(cfg, x, lp, attn[:, None])
    logits = _logits(cfg, params, x)[:, 0]
    return logits, k_pool, v_pool
