"""Whisper-style encoder-decoder ASR model (port of
``gofr_tpu/models/whisper.py``; BASELINE.json configs[3]).

Whisper-large-v3 shape at full scale: a two-convolution frontend over the
log-mel frames (the second of stride 2) with sinusoidal positions, a
pre-norm encoder; a decoder with self- and cross-attention and learned
positions whose output head is the token embedding. Plain functions over
the reference's params layout (stacked layers ``[L, ...]`` in the model
dtype, norms and biases in f32; ``k_proj`` has no bias), exact (erf) GELU,
f32 norms, softmax and logits. Greedy transcription decodes into a dense
self-attention cache (:class:`DecCache`, written in place as the
reference's donated one is) and recomputes the cross-attention K/V from
the encoder states every step, as the reference does. No kernel of the
port is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.attention import attention, decode_attention
from gofr_tpu_torch.ops.matmul import matmul_f32
from gofr_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 128
    vocab_size: int = 51866
    d_model: int = 1280
    n_audio_layers: int = 32
    n_text_layers: int = 32
    n_heads: int = 20
    d_ff: int = 5120
    max_audio_len: int = 1500  # frames after the stride-2 conv (30 s)
    max_text_len: int = 448
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    sot_id: int = 50258
    eot_id: int = 50257

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def large_v3(cls, **kw: Any) -> "WhisperConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw: Any) -> "WhisperConfig":
        defaults = dict(
            n_mels=8, vocab_size=64, d_model=32, n_audio_layers=2, n_text_layers=2,
            n_heads=2, d_ff=64, max_audio_len=32, max_text_len=16,
            dtype=torch.float32, sot_id=1, eot_id=2,
        )
        defaults.update(kw)
        return cls(**defaults)


def _sinusoids(length: int, channels: int, device: torch.device) -> torch.Tensor:
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def init_params(
    cfg: WhisperConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random params on ``device`` (the card by default), the reference's
    tree: weights drawn in f32 over sqrt(fan_in) and cast to the model
    dtype, norm scales one, biases zero. ``generator`` must live on that
    device; None seeds one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D, Fd = cfg.d_model, cfg.d_ff
    La, Lt = cfg.n_audio_layers, cfg.n_text_layers

    def winit(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def const(shape: tuple, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def block(L: int, cross: bool) -> dict:
        p = {name: winit((L, D, D), D) for name in ("wq", "wk", "wv", "wo")}
        if cross:
            p.update({name: winit((L, D, D), D) for name in ("xwq", "xwk", "xwv", "xwo")})
        p["w1"] = winit((L, D, Fd), D)
        p["w2"] = winit((L, Fd, D), Fd)
        biases = ("bq", "bv", "bo") + (("xbq", "xbv", "xbo") if cross else ())
        p.update({name: const((L, D), 0.0) for name in biases})
        p["b1"] = const((L, Fd), 0.0)
        p["b2"] = const((L, D), 0.0)
        for norm in ("ln1", "lnx", "ln2") if cross else ("ln1", "ln2"):
            p[norm + "_s"] = const((L, D), 1.0)
            p[norm + "_b"] = const((L, D), 0.0)
        return p

    return {
        "conv1": winit((3, cfg.n_mels, D), 3 * cfg.n_mels),
        "conv1_b": const((D,), 0.0),
        "conv2": winit((3, D, D), 3 * D),
        "conv2_b": const((D,), 0.0),
        "enc": block(La, cross=False),
        "enc_ln_s": const((D,), 1.0),
        "enc_ln_b": const((D,), 0.0),
        "tok_embedding": winit((cfg.vocab_size, D), D),
        "pos_embedding": winit((cfg.max_text_len, D), D),
        "dec": block(Lt, cross=True),
        "dec_ln_s": const((D,), 1.0),
        "dec_ln_b": const((D,), 0.0),
    }


def _layer_params(stack: dict, layer: int) -> dict:
    return {name: w[layer] for name, w in stack.items()}


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """[B, T, Cin] * [K, Cin, Cout] -> [B, T', Cout], padding 1 on both sides
    (the published Whisper conv layout) for either stride."""
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=1)
    out = out.transpose(1, 2)
    return out + b.to(out.dtype)


def _mlp(lp: dict, m: torch.Tensor) -> torch.Tensor:
    inter = F.gelu((m @ lp["w1"] + lp["b1"].to(m.dtype)).float()).to(m.dtype)
    return inter @ lp["w2"] + lp["b2"].to(m.dtype)


def encode_audio(cfg: WhisperConfig, params: dict, mel: torch.Tensor) -> torch.Tensor:
    """[B, T_frames, n_mels] -> encoder states [B, T', D] (T' = ceil(T/2))."""
    x = mel.to(cfg.dtype)
    x = F.gelu(_conv1d(x, params["conv1"], params["conv1_b"], 1).float()).to(cfg.dtype)
    x = F.gelu(_conv1d(x, params["conv2"], params["conv2_b"], 2).float()).to(cfg.dtype)
    B, T, D = x.shape
    x = x + _sinusoids(T, cfg.d_model, x.device).to(cfg.dtype)[None]
    H, Dh = cfg.n_heads, cfg.head_dim
    for layer in range(cfg.n_audio_layers):
        lp = _layer_params(params["enc"], layer)
        a = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        q = (a @ lp["wq"] + lp["bq"].to(a.dtype)).reshape(B, T, H, Dh)
        k = (a @ lp["wk"]).reshape(B, T, H, Dh)  # k_proj has no bias
        v = (a @ lp["wv"] + lp["bv"].to(a.dtype)).reshape(B, T, H, Dh)
        attn = attention(q, k, v, causal=False).reshape(B, T, D)
        x = x + attn @ lp["wo"] + lp["bo"].to(x.dtype)
        x = x + _mlp(lp, layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps))
    return layer_norm(x, params["enc_ln_s"], params["enc_ln_b"], cfg.norm_eps)


@dataclasses.dataclass
class DecCache:
    """Decoder self-attention KV cache [Lt, B, S_text, H, Dh] per k/v."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: WhisperConfig, batch: int,
               device: str | torch.device | None = None) -> "DecCache":
        dev = resolve_device(device)
        shape = (cfg.n_text_layers, batch, cfg.max_text_len, cfg.n_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


def decode_text_step(
    cfg: WhisperConfig,
    params: dict,
    enc_states: torch.Tensor,  # [B, T', D]
    tokens: torch.Tensor,  # [B] current token
    cache: DecCache,
    pos: torch.Tensor,  # [B] position of this token (0-based)
) -> tuple[torch.Tensor, DecCache]:
    """One decoder step -> (logits [B, V] f32, cache). Writes this token's
    K/V at ``pos`` of each row into ``cache`` in place."""
    B = tokens.shape[0]
    H, Dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    b_idx = torch.arange(B, device=tokens.device)
    x = (params["tok_embedding"][tokens] + params["pos_embedding"][pos]).to(cfg.dtype)[:, None]
    for layer in range(cfg.n_text_layers):
        lp = _layer_params(params["dec"], layer)
        a = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        q = (a @ lp["wq"] + lp["bq"].to(a.dtype)).reshape(B, 1, H, Dh)
        k = (a @ lp["wk"]).reshape(B, 1, H, Dh)  # k_proj has no bias
        v = (a @ lp["wv"] + lp["bv"].to(a.dtype)).reshape(B, 1, H, Dh)
        kc, vc = cache.k[layer], cache.v[layer]
        kc[b_idx, pos] = k[:, 0]
        vc[b_idx, pos] = v[:, 0]
        attn = decode_attention(q, kc, vc, pos + 1).reshape(B, 1, D)
        x = x + attn @ lp["wo"] + lp["bo"].to(x.dtype)

        xa = layer_norm(x, lp["lnx_s"], lp["lnx_b"], cfg.norm_eps)
        xq = (xa @ lp["xwq"] + lp["xbq"].to(xa.dtype)).reshape(B, 1, H, Dh)
        xk = (enc_states @ lp["xwk"]).reshape(B, -1, H, Dh)
        xv = (enc_states @ lp["xwv"] + lp["xbv"].to(enc_states.dtype)).reshape(B, -1, H, Dh)
        xattn = attention(xq, xk, xv, causal=False).reshape(B, 1, D)
        x = x + xattn @ lp["xwo"] + lp["xbo"].to(x.dtype)

        x = x + _mlp(lp, layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps))
    x = layer_norm(x, params["dec_ln_s"], params["dec_ln_b"], cfg.norm_eps)
    logits = matmul_f32(x, params["tok_embedding"].T)[:, 0]
    return logits, cache


def transcribe(
    cfg: WhisperConfig,
    params: dict,
    mel: torch.Tensor,  # [B, T_frames, n_mels]
    max_tokens: int | None = None,
) -> list[list[int]]:
    """Greedy transcription from ``sot_id``: token ids per row, trimmed at
    EOT. Reads the step's tokens to the host once a step (to stop when
    every row has seen EOT), as the reference does."""
    B = mel.shape[0]
    dev = mel.device
    max_tokens = min(max_tokens or cfg.max_text_len - 1, cfg.max_text_len - 1)
    enc_states = encode_audio(cfg, params, mel)
    cache = DecCache.create(cfg, B, dev)
    tokens = torch.full((B,), cfg.sot_id, dtype=torch.int64, device=dev)
    # -1 fill: token id 0 is a legitimate vocab entry, not a terminator
    out = np.full((B, max_tokens), -1, np.int64)
    steps_done = 0
    for step in range(max_tokens):
        pos = torch.full((B,), step, dtype=torch.int64, device=dev)
        logits, cache = decode_text_step(cfg, params, enc_states, tokens, cache, pos)
        tokens = torch.argmax(logits, dim=-1)
        out[:, step] = tokens.cpu().numpy()
        steps_done = step + 1
        if bool((out[:, :steps_done] == cfg.eot_id).any(axis=1).all()):
            break
    results: list[list[int]] = []
    for row in out[:, :steps_done]:
        ids: list[int] = []
        for t in row:
            if t == cfg.eot_id or t == -1:
                break
            ids.append(int(t))
        results.append(ids)
    return results
