"""Llama-family decoder (port of ``gofr_tpu/models/llama.py``, serving half).

Plain functions over a params dict of tensors, with the JAX package's
layouts: stacked layer weights ``[L, ...]`` (kept stacked; a layer is a
view ``w[l]``), ``[B, S, H, D]`` activations, the dense slot cache
``[L, B, S_max, Hkv, Dh]`` (:class:`KVCache`), paged pools
``[L, N+1, Hkv, page, Dh]`` whose last page is the trash page. bf16
weights and activations with f32 norms, softmax and logits. A matmul
weight may be weight-only int8, ``{"q": int8, "s": f32 per output
channel}`` (:func:`quantize_weight`).

What the JAX package donates is updated in place here: ``decode_step``,
``decode_chunk``, ``decode_step_paged`` and ``decode_chunk_paged`` (and
their int8 twins) write K/V, and for int8 caches its scales, into the
cache or pools they are given and return them.

Kept: ``LlamaConfig``, ``init_params`` (bf16 or weight-only int8),
``quantize_weight``/``quantize_params``, ``param_count``/``param_bytes``,
``prefill`` into a dense ``KVCache`` (bf16 or int8; the serving path's
slab form is ``_prefill_slabs``), per-vector int8 ``quantize_kv``/
``dequantize_kv``, the dense ``KVCache`` with ``decode_step``,
``decode_step_greedy``, ``decode_loop_greedy``, ``greedy_generate`` and
the chunk forward ``decode_chunk``, and the paged ``decode_step_paged``/
``_q`` and ``decode_chunk_paged``/``_q``. Waiting for later slices:
``forward``, speculative generation, tied embeddings and context
parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.attention import attention, decode_attention
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
    quantize: bool = False,
) -> dict:
    """Random params with stacked layers [L, ...], made on ``device`` (the
    card by default) in the model dtype, so an 8B model never exists on the
    host. ``generator`` must live on that device; None seeds one with 0.
    ``quantize=True`` makes every matmul weight weight-only int8
    (:func:`quantize_weight`) as it is drawn, so the peak is the int8 total
    plus one model-dtype leaf; the draws are those of ``quantize=False``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def winit(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=dev, dtype=cfg.dtype)
        return w.div_(math.sqrt(fan_in))

    def mm_weight(shape: tuple, fan_in: int) -> torch.Tensor | dict:
        w = winit(shape, fan_in)
        return quantize_weight(w, axis=-2) if quantize else w

    params: dict = {
        "embedding": winit((cfg.vocab_size, D), D),
        "layers": {
            "wq": mm_weight((L, D, H * Dh), D),
            "wk": mm_weight((L, D, Hkv * Dh), D),
            "wv": mm_weight((L, D, Hkv * Dh), D),
            "wo": mm_weight((L, H * Dh, D), H * Dh),
            "w_gate": mm_weight((L, D, Fd), D),
            "w_up": mm_weight((L, D, Fd), D),
            "w_down": mm_weight((L, Fd, D), Fd),
            "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": mm_weight((D, cfg.vocab_size), D),
    }
    return params


def _leaves(tree: Any, key: str | None = None):
    """(key, tensor) of every leaf of a nested params dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    else:
        yield key, tree


def param_count(params: dict) -> int:
    """Model parameters; the int8 scales (``"s"`` leaves) are metadata."""
    return sum(t.numel() for key, t in _leaves(params) if key != "s")


def param_bytes(params: dict) -> int:
    """Resident bytes of the params (int8 ``q`` and f32 ``s`` as they are)."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))


def layer_params(params: dict, layer: int) -> dict:
    """Layer ``layer``'s weights as views into the stacked leaves (both
    tensors of a weight-only int8 leaf)."""
    return {
        name: ({k: t[layer] for k, t in w.items()} if isinstance(w, dict) else w[layer])
        for name, w in params["layers"].items()
    }


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


# ------------------------------------------------------- weight-only int8
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_body(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_quantize_body`` as its jitted form computes it:
    the absmax times f32(1/127) (XLA's product for the division by 127),
    floored at 1e-12, then a true division and half-to-even rounding."""
    amax = w.abs().amax(dim=axis, keepdim=True).float()
    s = torch.clamp_min(amax * _INV_127, 1e-12)
    q = torch.clamp(torch.round(w.float() / s), -127, 127).to(torch.int8)
    return q, s.squeeze(axis)


def quantize_weight(w: torch.Tensor, axis: int = -2) -> dict:
    """Symmetric per-output-channel weight-only int8: ``axis`` is the
    contraction (input) axis; returns ``{"q": int8 same shape, "s": f32
    per output channel}``. A stacked leaf [L, ...] quantizes one layer at a
    time, so the f32 transient is one layer's (an eager f32 copy of an 8B
    ``w_gate`` would be 7.5 GB)."""
    axis %= w.ndim
    if w.ndim < 3 or axis == 0:
        q, s = _quantize_body(w, axis)
        return {"q": q, "s": s}
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:axis] + w.shape[axis + 1:], dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = _quantize_body(w[i], axis - 1)
    return {"q": q, "s": s}


def quantize_params(params: dict) -> dict:
    """Quantize every matmul weight of a resident params tree (the layers'
    ``_QUANT_KEYS`` and the lm_head); the embedding and norms stay as they
    are, and leaves already quantized are kept."""
    layers = {
        k: (quantize_weight(v, axis=-2) if k in _QUANT_KEYS and not isinstance(v, dict) else v)
        for k, v in params["layers"].items()
    }
    out = dict(params, layers=layers)
    if "lm_head" in params and not isinstance(params["lm_head"], dict):
        out["lm_head"] = quantize_weight(params["lm_head"], axis=-2)
    return out


def _mm(x: torch.Tensor, w: torch.Tensor | dict) -> torch.Tensor:
    """Projection matmul in the activation dtype (f32 accumulation inside
    the GEMM), as ``x @ w`` is in the reference. A weight-only int8 weight
    converts to the activation dtype, multiplies with an f32 result, takes
    its per-output-channel scale and rounds to the activation dtype. XLA
    fuses that convert into the dot; here it is a separate copy of the
    weight on every call."""
    if isinstance(w, dict):
        return (_matmul_f32(x, w["q"].to(x.dtype)) * w["s"]).to(x.dtype)
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
    """Final norm + lm_head, f32 logits [..., V]; a weight-only int8 head
    takes its scale on the f32 product, with no rounding after it."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["lm_head"]
    if isinstance(head, dict):
        return _matmul_f32(x, head["q"].to(x.dtype)) * head["s"]
    return _matmul_f32(x, head)


def _embed(cfg: LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens].to(cfg.dtype)


def _prefill_layers(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, S] right-padded
    seq_lens: torch.Tensor,  # [B] true lengths
    store: Any,  # store(layer, k, v): keeps one layer's fresh K/V [B, S, Hkv, Dh]
) -> torch.Tensor:
    """The prefill forward: hands each layer's K/V to ``store`` and returns
    the last-token logits [B, V] f32. Attention is the flash kernel (its
    plain version on the CPU) over the fresh full-precision K/V; positions
    past ``seq_lens`` still attend to the valid keys and their K/V is
    masked at every later read."""
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    kv_len = seq_lens.to(device=dev, dtype=torch.int32)
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _qkv(cfg, x, lp, sin, cos, positions)
        store(layer, k, v)
        attn = flash_attention(q, k, v, kv_len, causal=True)
        x = _attn_mlp_epilogue(cfg, x, lp, attn)
    # the last valid position's hidden state BEFORE the lm_head: [B, S, V]
    # logits only to keep one position would waste 2*B*S*D*V FLOPs
    last_idx = (kv_len.long() - 1).clamp(0, S - 1)
    last_h = x[torch.arange(B, device=dev), last_idx][:, None]  # [B, 1, D]
    return _logits(cfg, params, last_h)[:, 0]


def _prefill_slabs(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, S] right-padded
    seq_lens: torch.Tensor,  # [B] true lengths (int32)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill into fresh slabs: (last-token logits [B, V] f32, k_slab,
    v_slab [L, B, S, Hkv, Dh]) in the model dtype, for the serving path's
    commit into a slot row or into pages (``batch.prefill_compute``)."""
    B, S = tokens.shape
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    k_slab = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
    v_slab = torch.empty_like(k_slab)

    def store(layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        k_slab[layer] = k
        v_slab[layer] = v

    return _prefill_layers(cfg, params, tokens, seq_lens, store), k_slab, v_slab


def prefill(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, S] right-padded
    cache: KVCache,  # written in place
    seq_lens: torch.Tensor,  # [B] true lengths
) -> tuple[torch.Tensor, KVCache]:
    """Prefill: fill rows [:B], positions [:S] of each layer of ``cache``
    in place (into an int8 cache quantized per vector, values and scales)
    and return (last-token logits [B, V] f32, cache). Attention reads the
    fresh full-precision K/V, not the quantized ones."""
    B, S = tokens.shape

    def store(layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        if cache.quantized:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            for field, value in zip(cache.tensors(), (kq, vq, ks, vs)):
                field[layer, :B, :S] = value
        else:
            cache.k[layer, :B, :S] = k
            cache.v[layer, :B, :S] = v

    return _prefill_layers(cfg, params, tokens, seq_lens, store), cache


# ------------------------------------------------------- dense slot cache
@dataclasses.dataclass
class KVCache:
    """Dense KV cache: ``k``, ``v`` [L, B, S_max, Hkv, Dh] on one device;
    with ``kv_dtype="int8"`` they hold int8 values and ``ks``, ``vs``
    [L, B, S_max, Hkv] their f32 per-vector absmax scales
    (:func:`quantize_kv`), dequantized whole at the attention read.

    The reference's scatters drop a write aimed past ``S_max`` (a frozen
    row's decode step, a chunk's tail, a row that is not chunking); on the
    card an out-of-range index is a device assert instead. So the storage
    behind each tensor made by :meth:`create` holds one more position past
    its end, the sink, and a write the reference drops goes there
    (:func:`_cache_rows`); the fields are views of everything before it."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None

    @classmethod
    def create(
        cls, cfg: LlamaConfig, batch: int, max_len: int | None = None,
        kv_dtype: str | None = None, *, device: str | torch.device | None = None,
    ) -> "KVCache":
        dev = resolve_device(device)
        S = max_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)

        def zeros(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
            flat = torch.zeros((math.prod(shape[:3]) + 1, *shape[3:]), dtype=dtype, device=dev)
            return flat[:-1].view(shape)

        if kv_dtype == "int8":
            return cls(zeros(shape, torch.int8), zeros(shape, torch.int8),
                       zeros(shape[:-1], torch.float32), zeros(shape[:-1], torch.float32))
        return cls(zeros(shape, cfg.dtype), zeros(shape, cfg.dtype))

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def tensors(self) -> tuple:
        """(k, v, ks, vs); the scales are None for bf16."""
        return self.k, self.v, self.ks, self.vs


def _cache_rows(t: torch.Tensor) -> torch.Tensor:
    """A cache tensor [L, B, S_max, ...] as its rows [L*B*S_max + 1, ...],
    the last row the sink past its end (see :class:`KVCache`)."""
    n = t.shape[0] * t.shape[1] * t.shape[2]
    tail = t.shape[3:]
    row = math.prod(tail)
    end = (t.storage_offset() + (n + 1) * row) * t.element_size()
    if not t.is_contiguous() or t.untyped_storage().nbytes() < end:
        raise ValueError("a dense cache tensor needs the sink position KVCache.create allocates")
    return t.as_strided((n + 1, *tail), t.stride()[2:], t.storage_offset())


def _dense_targets(cache: KVCache, rows: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Flat rows [L, K, T] of writes at (layer, ``rows``, ``positions``
    [K, T]): a position outside [0, S_max), whose write the reference
    drops, goes to the sink. Many writes may meet at the sink; none meets
    another anywhere else."""
    L, B, S = cache.k.shape[:3]
    valid = (positions >= 0) & (positions < S)
    flat = rows.long()[:, None] * S + positions
    layer_base = torch.arange(L, device=positions.device)[:, None, None] * (B * S)
    return torch.where(valid[None], flat[None] + layer_base, L * B * S)


def _write_dense(rows_views: list, idx: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Scatter K/V [..., Hkv, Dh] to flat rows ``idx`` of the cache's row
    views (:func:`_cache_rows` of k, v and, for int8, ks, vs); into int8
    the values quantize first and their scales go to the same rows."""
    if len(rows_views) == 2:
        rows_views[0][idx] = k
        rows_views[1][idx] = v
        return
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    for view, value in zip(rows_views, (kq, vq, ks, vs)):
        view[idx] = value


def _dense_layer_kv(
    cache: KVCache, layer: int, rows: torch.Tensor | None, dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``layer``'s K/V [B (or the ``rows``), S_max, Hkv, Dh] in the
    compute dtype: an int8 layer dequantizes whole, as the reference's
    decode and chunk reads do."""
    k, v = cache.k[layer], cache.v[layer]
    if rows is not None:
        k, v = k[rows], v[rows]
    if not cache.quantized:
        return k, v
    ks, vs = cache.ks[layer], cache.vs[layer]
    if rows is not None:
        ks, vs = ks[rows], vs[rows]
    return dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype)


def decode_step(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B] last sampled token per row
    cache: KVCache,  # updated in place
    cache_len: torch.Tensor,  # [B] length including this token's position
) -> tuple[torch.Tensor, KVCache]:
    """One decode step over the dense cache: this token's K/V go to
    (layer, row, cache_len-1), quantized first into an int8 cache, and
    each row attends over its whole layer cache masked by ``cache_len``.
    A row at ``S_max + 1`` (frozen) writes to the sink, and its RoPE
    position clamps into the table where the reference's ``jnp.take``
    fills NaN (when ``S_max`` is the model's ``max_seq_len``); its logits
    are never read. Returns (logits [B, V] f32, cache). Issues no host
    sync."""
    B = tokens.shape[0]
    dev = tokens.device
    x = _embed(cfg, params, tokens)[:, None, :]  # [B, 1, D]
    pos = cache_len.long()[:, None] - 1  # [B, 1]
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    rope_pos = pos.clamp(0, cfg.max_seq_len - 1)
    idx = _dense_targets(cache, torch.arange(B, device=dev), pos)
    views = [_cache_rows(t) for t in cache.tensors() if t is not None]
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _qkv(cfg, x, lp, sin, cos, rope_pos)
        _write_dense(views, idx[layer], k, v)
        kc, vc = _dense_layer_kv(cache, layer, None, cfg.dtype)
        attn = decode_attention(q, kc, vc, cache_len)
        x = _attn_mlp_epilogue(cfg, x, lp, attn)
    return _logits(cfg, params, x)[:, 0], cache


def decode_step_greedy(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B]
    cache: KVCache,  # updated in place
    cache_len: torch.Tensor,  # [B] length BEFORE this token's position
) -> tuple[torch.Tensor, KVCache, torch.Tensor]:
    """:func:`decode_step` with the length increment before it and the
    greedy argmax after it: (next tokens [B], cache, cache_len + 1)."""
    cache_len = cache_len + 1
    logits, cache = decode_step(cfg, params, tokens, cache, cache_len)
    return logits.argmax(dim=-1), cache, cache_len


def decode_loop_greedy(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B]
    cache: KVCache,  # updated in place
    cache_len: torch.Tensor,  # [B] length BEFORE the first new position
    n_steps: int,
) -> tuple[torch.Tensor, KVCache, torch.Tensor, torch.Tensor]:
    """``n_steps`` of :func:`decode_step_greedy`: (last tokens, cache,
    cache_len, tokens [B, n_steps])."""
    out = []
    for _ in range(n_steps):
        tokens, cache, cache_len = decode_step_greedy(cfg, params, tokens, cache, cache_len)
        out.append(tokens)
    toks = torch.stack(out, dim=1) if out else tokens.new_empty((tokens.shape[0], 0))
    return tokens, cache, cache_len, toks


def greedy_generate(
    cfg: LlamaConfig,
    params: dict,
    prompt: torch.Tensor,  # [B, S] right-padded
    seq_lens: torch.Tensor,  # [B]
    max_new_tokens: int,
) -> torch.Tensor:
    """Greedy generation (the library entry point and the test oracle):
    :func:`prefill` into a ``KVCache(B, S + max_new_tokens)`` in the model
    dtype, then one :func:`decode_step` per token. Returns
    [B, max_new_tokens]."""
    B, S = prompt.shape
    cache = KVCache.create(cfg, B, max_len=S + max_new_tokens, device=prompt.device)
    logits, cache = prefill(cfg, params, prompt, cache, seq_lens)
    tokens = logits.argmax(dim=-1)
    out = [tokens]
    cache_len = seq_lens.to(torch.int32)
    for _ in range(max_new_tokens - 1):
        cache_len = cache_len + 1
        logits, cache = decode_step(cfg, params, tokens, cache, cache_len)
        tokens = logits.argmax(dim=-1)
        out.append(tokens)
    return torch.stack(out, dim=1)


def _dense_chunk_forward(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [K, T] chunk tokens (-1 pads the ragged tail)
    cache: KVCache,  # [L, B, S_max, ...], written in place
    rows: torch.Tensor,  # [K] distinct cache rows the chunk rows live in
    start_len: torch.Tensor,  # [K] committed length BEFORE the chunk
) -> torch.Tensor:
    """The chunk forward of :func:`decode_chunk` up to the final hidden
    state [K, T, D], for the cache ``rows`` alone: writes the chunk's K/V
    in place at [layer, rows, start:start+T] (positions past ``S_max`` to
    the sink) and attends over those rows' layer cache with per-row
    ``q_offset``."""
    T = tokens.shape[1]
    dev = tokens.device
    start = start_len.long()
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]  # [K, T]
    x = _embed(cfg, params, tokens.clamp_min(0))
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    # pad positions of a final ragged chunk may run past the rope table:
    # they clamp into it (the reference's jnp.take fills NaN there); their
    # outputs are never read
    rope_pos = positions.clamp_max(cfg.max_seq_len - 1)
    kv_len = start + T
    idx = _dense_targets(cache, rows, positions)
    views = [_cache_rows(t) for t in cache.tensors() if t is not None]
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _qkv(cfg, x, lp, sin, cos, rope_pos)
        _write_dense(views, idx[layer], k, v)
        kc, vc = _dense_layer_kv(cache, layer, rows, cfg.dtype)
        attn = attention(q, kc, vc, causal=True, q_offset=start, kv_len=kv_len)
        x = _attn_mlp_epilogue(cfg, x, lp, attn)
    return x


def decode_chunk(
    cfg: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, T]
    cache: KVCache,  # updated in place
    start_len: torch.Tensor,  # [B] committed length BEFORE the chunk
) -> tuple[torch.Tensor, KVCache]:
    """Run T tokens per row against the dense cache in one call: K/V
    written at rows [start, start+T) (past ``S_max`` dropped, to the sink),
    attention over prefix and chunk with per-row ``q_offset``. Returns
    (logits [B, T, V] f32, cache)."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    x = _dense_chunk_forward(cfg, params, tokens, cache, rows, start_len)
    return _logits(cfg, params, x), cache


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
    # pad positions of a final ragged chunk may run past the rope table:
    # they clamp into it (the reference's jnp.take fills NaN there); their
    # outputs are never read
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
