"""BERT-style encoder for the /embed endpoint (port of
``gofr_tpu/models/bert.py``; BASELINE.json configs[1]).

Plain functions over a params dict with the reference's layout: stacked
layer weights ``[L, ...]`` in the model dtype, norms and biases in f32
(each bias cast to the activation dtype before its add). Post-norm layers,
the plain non-causal ``attention`` masked by each row's length, and the
tanh GELU that ``jax.nn.gelu`` computes by default. BERT-base shape:
12L/12H/768d/3072ff/30522V. No kernel of the port is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    n_types: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def base(cls, **kw: Any) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw: Any) -> "BertConfig":
        defaults = dict(
            vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_seq_len=64, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: BertConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random params on ``device`` (the card by default): weights drawn in
    f32 over sqrt(fan_in) and cast to the model dtype, norm scales one,
    biases zero. ``generator`` must live on that device; None seeds one
    with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff

    def winit(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def const(shape: tuple, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "embedding": winit((cfg.vocab_size, D), D),
        "pos_embedding": winit((cfg.max_seq_len, D), D),
        "type_embedding": winit((cfg.n_types, D), D),
        "embed_norm_scale": const((D,), 1.0),
        "embed_norm_bias": const((D,), 0.0),
        "layers": {
            "wq": winit((L, D, D), D),
            "wk": winit((L, D, D), D),
            "wv": winit((L, D, D), D),
            "wo": winit((L, D, D), D),
            "w_inter": winit((L, D, Fd), D),
            "w_out": winit((L, Fd, D), Fd),
            "attn_norm_scale": const((L, D), 1.0),
            "attn_norm_bias": const((L, D), 0.0),
            "mlp_norm_scale": const((L, D), 1.0),
            "mlp_norm_bias": const((L, D), 0.0),
            "bq": const((L, D), 0.0),
            "bk": const((L, D), 0.0),
            "bv": const((L, D), 0.0),
            "bo": const((L, D), 0.0),
            "b_inter": const((L, Fd), 0.0),
            "b_out": const((L, D), 0.0),
        },
        "pooler_w": winit((D, D), D),
        "pooler_b": const((D,), 0.0),
    }


def _layer(cfg: BertConfig, x: torch.Tensor, lp: dict, mask_len: torch.Tensor) -> torch.Tensor:
    B, S, D = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q = (x @ lp["wq"] + lp["bq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ lp["wk"] + lp["bk"].to(x.dtype)).reshape(B, S, H, Dh)
    v = (x @ lp["wv"] + lp["bv"].to(x.dtype)).reshape(B, S, H, Dh)
    attn = attention(q, k, v, causal=False, kv_len=mask_len)
    attn = attn.reshape(B, S, D) @ lp["wo"] + lp["bo"].to(x.dtype)
    x = layer_norm(x + attn, lp["attn_norm_scale"], lp["attn_norm_bias"], cfg.norm_eps)
    inter = F.gelu((x @ lp["w_inter"] + lp["b_inter"].to(x.dtype)).float(), approximate="tanh")
    out = inter.to(x.dtype) @ lp["w_out"] + lp["b_out"].to(x.dtype)
    return layer_norm(x + out, lp["mlp_norm_scale"], lp["mlp_norm_bias"], cfg.norm_eps)


def encode(
    cfg: BertConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, S] right-padded
    seq_lens: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Token encoding -> hidden states [B, S, D] in the model dtype."""
    S = tokens.shape[1]
    x = (
        params["embedding"][tokens]
        + params["pos_embedding"][:S][None, :, :]
        + params["type_embedding"][0]
    ).to(cfg.dtype)
    x = layer_norm(x, params["embed_norm_scale"], params["embed_norm_bias"], cfg.norm_eps)
    for layer in range(cfg.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        x = _layer(cfg, x, lp, seq_lens)
    return x


def embed(
    cfg: BertConfig,
    params: dict,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """Mean-pooled, L2-normalized sentence embedding [B, D] f32: the /embed
    endpoint's payload (BASELINE.json configs[1])."""
    hidden = encode(cfg, params, tokens, seq_lens)
    lens = seq_lens.to(device=tokens.device)
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lens[:, None])[..., None]
    summed = torch.sum(hidden.float() * mask, dim=1)
    pooled = summed / torch.clamp_min(lens[:, None].float(), 1.0)
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-12)
