"""HF-layout Whisper checkpoint import (port of
``gofr_tpu/models/whisper_import.py``).

Loads ``WhisperForConditionalGeneration`` safetensors weights (the
openai/whisper-* layout) into ``models/whisper.py``'s stacked tree, the ASR
twin of ``hf_import.load_llama_from_hf``. Mapping (HF module path -> tree):

- ``model.encoder.conv{1,2}.weight`` [D, Cin, K] -> ``conv{1,2}`` [K, Cin, D]
- ``model.encoder.layers.N.self_attn.{q,k,v,out}_proj`` -> enc ``wq/wk/wv/wo``
  (weights transposed to right-multiply form; k_proj has no bias)
- ``model.decoder.layers.N.encoder_attn.*`` -> dec ``xw*`` (cross-attention)
- ``model.decoder.embed_tokens.weight`` -> ``tok_embedding`` (tied proj_out)
- ``model.decoder.embed_positions.weight`` -> ``pos_embedding`` (learned)
- encoder positions are not loaded: HF stores the same sinusoid table
  ``models/whisper.py`` computes.

Weights take the model dtype, biases and norms f32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.models.hf_import import _open_checkpoint, read_json, to_leaf
from gofr_tpu_torch.models.whisper import WhisperConfig


def whisper_config_from_hf(path: str, fs: Any = None, **overrides: Any) -> WhisperConfig:
    raw = read_json(os.path.join(path, "config.json"), fs)
    fields = dict(
        n_mels=raw["num_mel_bins"],
        vocab_size=raw["vocab_size"],
        d_model=raw["d_model"],
        n_audio_layers=raw["encoder_layers"],
        n_text_layers=raw["decoder_layers"],
        n_heads=raw["encoder_attention_heads"],
        d_ff=raw["encoder_ffn_dim"],
        max_audio_len=raw.get("max_source_positions", 1500),
        max_text_len=raw.get("max_target_positions", 448),
        sot_id=raw.get("decoder_start_token_id", 50258),
        eot_id=raw.get("eos_token_id", 50257),
    )
    fields.update(overrides)
    return WhisperConfig(**fields)


def load_whisper_from_hf(
    path: str,
    *,
    dtype: torch.dtype | None = None,
    fs: Any = None,
    device: str | torch.device | None = None,
    **config_overrides: Any,
) -> tuple[WhisperConfig, dict]:
    """(cfg, params) from an HF Whisper checkpoint directory, the params on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    cfg = whisper_config_from_hf(path, fs=fs, **config_overrides)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    raw = _open_checkpoint(path, fs=fs)

    def t(name: str) -> torch.Tensor:
        # some exports prefix everything with "model."
        if name in raw:
            return raw[name]
        if "model." + name in raw:
            return raw["model." + name]
        raise KeyError(f"missing tensor {name}")

    def put(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return to_leaf(x, dt, dev)

    def wstack(fmt: str, n: int) -> torch.Tensor:
        return put(torch.stack([t(fmt.format(i)).T for i in range(n)]), cfg.dtype)

    def bstack(fmt: str, n: int) -> torch.Tensor:
        return put(torch.stack([t(fmt.format(i)) for i in range(n)]), torch.float32)

    La, Lt = cfg.n_audio_layers, cfg.n_text_layers
    e = "encoder.layers.{}."
    d = "decoder.layers.{}."

    enc = {
        "wq": wstack(e + "self_attn.q_proj.weight", La),
        "wk": wstack(e + "self_attn.k_proj.weight", La),
        "wv": wstack(e + "self_attn.v_proj.weight", La),
        "wo": wstack(e + "self_attn.out_proj.weight", La),
        "bq": bstack(e + "self_attn.q_proj.bias", La),
        "bv": bstack(e + "self_attn.v_proj.bias", La),
        "bo": bstack(e + "self_attn.out_proj.bias", La),
        "w1": wstack(e + "fc1.weight", La),
        "b1": bstack(e + "fc1.bias", La),
        "w2": wstack(e + "fc2.weight", La),
        "b2": bstack(e + "fc2.bias", La),
        "ln1_s": bstack(e + "self_attn_layer_norm.weight", La),
        "ln1_b": bstack(e + "self_attn_layer_norm.bias", La),
        "ln2_s": bstack(e + "final_layer_norm.weight", La),
        "ln2_b": bstack(e + "final_layer_norm.bias", La),
    }
    dec = {
        "wq": wstack(d + "self_attn.q_proj.weight", Lt),
        "wk": wstack(d + "self_attn.k_proj.weight", Lt),
        "wv": wstack(d + "self_attn.v_proj.weight", Lt),
        "wo": wstack(d + "self_attn.out_proj.weight", Lt),
        "bq": bstack(d + "self_attn.q_proj.bias", Lt),
        "bv": bstack(d + "self_attn.v_proj.bias", Lt),
        "bo": bstack(d + "self_attn.out_proj.bias", Lt),
        "xwq": wstack(d + "encoder_attn.q_proj.weight", Lt),
        "xwk": wstack(d + "encoder_attn.k_proj.weight", Lt),
        "xwv": wstack(d + "encoder_attn.v_proj.weight", Lt),
        "xwo": wstack(d + "encoder_attn.out_proj.weight", Lt),
        "xbq": bstack(d + "encoder_attn.q_proj.bias", Lt),
        "xbv": bstack(d + "encoder_attn.v_proj.bias", Lt),
        "xbo": bstack(d + "encoder_attn.out_proj.bias", Lt),
        "w1": wstack(d + "fc1.weight", Lt),
        "b1": bstack(d + "fc1.bias", Lt),
        "w2": wstack(d + "fc2.weight", Lt),
        "b2": bstack(d + "fc2.bias", Lt),
        "ln1_s": bstack(d + "self_attn_layer_norm.weight", Lt),
        "ln1_b": bstack(d + "self_attn_layer_norm.bias", Lt),
        "lnx_s": bstack(d + "encoder_attn_layer_norm.weight", Lt),
        "lnx_b": bstack(d + "encoder_attn_layer_norm.bias", Lt),
        "ln2_s": bstack(d + "final_layer_norm.weight", Lt),
        "ln2_b": bstack(d + "final_layer_norm.bias", Lt),
    }
    params = {
        # HF Conv1d weight [out, in, k] -> [k, in, out]
        "conv1": put(t("encoder.conv1.weight").permute(2, 1, 0), cfg.dtype),
        "conv1_b": put(t("encoder.conv1.bias"), torch.float32),
        "conv2": put(t("encoder.conv2.weight").permute(2, 1, 0), cfg.dtype),
        "conv2_b": put(t("encoder.conv2.bias"), torch.float32),
        "enc": enc,
        "enc_ln_s": put(t("encoder.layer_norm.weight"), torch.float32),
        "enc_ln_b": put(t("encoder.layer_norm.bias"), torch.float32),
        "tok_embedding": put(t("decoder.embed_tokens.weight"), cfg.dtype),
        "pos_embedding": put(t("decoder.embed_positions.weight"), cfg.dtype),
        "dec": dec,
        "dec_ln_s": put(t("decoder.layer_norm.weight"), torch.float32),
        "dec_ln_b": put(t("decoder.layer_norm.bias"), torch.float32),
    }
    return cfg, params
