"""MoE Llama family (Mixtral shape) (port of ``gofr_tpu/models/moe.py``):
dense GQA attention and a top-k sparse expert FFN, through
``ops/moe.moe_ffn_reference`` off a mesh or ``ops/moe.moe_ffn_ep`` over
the mesh's ``ep`` axis (GShard all_to_all dispatch). Plain PyTorch, as the
reference's forward is plain XLA; attention is the plain ``attention``.

Kept: ``MoeConfig`` (``mixtral_8x7b``, ``tiny``), ``init_params`` from a
generator, ``forward(mesh=, return_aux=)``, ``load_balance_loss_from_stats``,
``load_balance_loss`` and ``moe_sharding_rules``. On a mesh every rank
runs the whole batch (as the reference's compiler may) and the expert FFN
groups the tokens over ``ep``: the params are the full tree, or this
rank's slice by ``moe_sharding_rules()`` on a mesh whose other axes are 1
but ``dp``. The full Mixtral-8x7B (~93 GB in bf16) is past one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.models.llama import _logits
from gofr_tpu_torch.ops import moe as moe_ops
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.rope import apply_rope, rope_table


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    aux_loss_coef: float = 0.01  # load-balance loss (Switch-style)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def mixtral_8x7b(cls, **kw: Any) -> "MoeConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw: Any) -> "MoeConfig":
        defaults = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, n_experts=4, top_k=2, max_seq_len=128, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: MoeConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random params with stacked layers [L, ...] on ``device`` (the card
    by default), in the model dtype but the f32 router and norms.
    ``generator`` must live on that device; None seeds one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def winit(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=dev, dtype=cfg.dtype)
        return w.div_(math.sqrt(fan_in))

    return {
        "embedding": winit((cfg.vocab_size, D), D),
        "layers": {
            "wq": winit((L, D, H * Dh), D),
            "wk": winit((L, D, Hkv * Dh), D),
            "wv": winit((L, D, Hkv * Dh), D),
            "wo": winit((L, H * Dh, D), H * Dh),
            "w_router": winit((L, D, E), D).float(),
            "w_gate": winit((L, E, D, Fd), D),
            "w_up": winit((L, E, D, Fd), D),
            "w_down": winit((L, E, Fd, D), Fd),
            "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": winit((D, cfg.vocab_size), D),
    }


def _moe_block(cfg: MoeConfig, lp: dict, h: torch.Tensor, mesh: Any):
    """FFN block: [B, S, D] -> ([B, S, D], (f_e, P_e)) through the MoE."""
    B, S, D = h.shape
    flat = h.reshape(B * S, D)
    if mesh is not None:
        out, f, p = moe_ops.moe_ffn_ep(
            flat, lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"], mesh,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, return_stats=True,
        )
    else:
        out, f, p = moe_ops.moe_ffn_reference(
            flat, lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"],
            top_k=cfg.top_k, return_stats=True,
        )
    return out.reshape(B, S, D), (f, p)


def _layer(cfg: MoeConfig, h: torch.Tensor, lp: dict, sin, cos, positions, mesh: Any = None):
    B, S, _ = h.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope((x @ lp["wq"]).reshape(B, S, H, Dh), positions, sin, cos)
    k = apply_rope((x @ lp["wk"]).reshape(B, S, Hkv, Dh), positions, sin, cos)
    v = (x @ lp["wv"]).reshape(B, S, Hkv, Dh)
    attn = attention(q, k, v, causal=True)
    h = h + attn.reshape(B, S, H * Dh) @ lp["wo"]
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    out, stats = _moe_block(cfg, lp, x, mesh)
    return h + out, stats


def _forward(cfg: MoeConfig, params: dict, tokens: torch.Tensor, mesh: Any):
    """(logits [B, S, V] f32, (f, p) each [L, E]): the reference's
    ``_forward_jit``."""
    if mesh is not None:
        others = {a: n for a, n in mesh.shape.items() if a not in ("ep", "dp") and n > 1}
        if others:
            raise ValueError(f"moe.forward on a mesh uses its ep axis (and repeats over dp); "
                             f"{others} would need the tensor-parallel attention")
    B, S = tokens.shape
    dev = tokens.device
    x = params["embedding"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    sin, cos = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    fs, ps = [], []
    for layer in range(cfg.n_layers):
        lp = {name: w[layer] for name, w in params["layers"].items()}
        x, (f, p) = _layer(cfg, x, lp, sin, cos, positions, mesh)
        fs.append(f)
        ps.append(p)
    return _logits(cfg, params, x), (torch.stack(fs), torch.stack(ps))


def forward(
    cfg: MoeConfig, params: dict, tokens: torch.Tensor, mesh: Any = None,
    return_aux: bool = False,
):
    """[B, S] -> logits [B, S, V] f32. With ``mesh`` (an ``ep`` axis) the
    expert FFNs run expert-parallel through all_to_all dispatch. With
    ``return_aux`` also the per-layer router stats (f, p), each [L, E],
    from the routing each layer's router really saw."""
    logits, stats = _forward(cfg, params, tokens, mesh)
    return (logits, stats) if return_aux else logits


def load_balance_loss_from_stats(cfg: MoeConfig, f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Switch-transformer auxiliary loss E · Σ_e f_e · P_e averaged over
    layers, from the per-layer routing stats the forward emits."""
    return torch.mean(cfg.n_experts * torch.sum(f * p, dim=-1))


def load_balance_loss(cfg: MoeConfig, params: dict, tokens: torch.Tensor,
                      mesh: Any = None) -> torch.Tensor:
    """Aux loss from a real forward (each router sees its layer's hidden
    states). ``forward(..., return_aux=True)`` with
    :func:`load_balance_loss_from_stats` avoids a second pass when the
    logits are needed too."""
    _, (f, p) = forward(cfg, params, tokens, mesh, return_aux=True)
    return load_balance_loss_from_stats(cfg, f, p)


def moe_sharding_rules():
    """Sharding rules for the MoE param tree: experts on ep, Megatron TP
    inside each expert, attention as in the llama rules."""
    from gofr_tpu_torch.parallel.sharding import P, ShardingRules

    return ShardingRules(
        [
            (r"embedding", P("tp", "fsdp")),
            (r"lm_head", P("fsdp", "tp")),
            (r"w[qkv]$", P(None, "fsdp", "tp")),
            (r"wo$", P(None, "tp", "fsdp")),
            (r"w_router", P()),
            (r"w_gate|w_up", P(None, "ep", None, "tp")),
            (r"w_down", P(None, "ep", "tp", None)),
            (r"norm", P()),
        ]
    )
