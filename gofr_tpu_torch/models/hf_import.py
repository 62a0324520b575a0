"""Load externally produced Llama checkpoints in the HF safetensors layout
(port of ``gofr_tpu/models/hf_import.py``).

Own safetensors reader, the reference's format code: an 8-byte
little-endian header length, a JSON header mapping tensor names to
``{dtype, shape, data_offsets}``, then raw little-endian tensor bytes. No
``safetensors`` (nor ``ml_dtypes``) is imported: a BF16 tensor crosses as
its ``uint16`` bits viewed as ``torch.bfloat16``, as ``models/convert.py``
carries bf16. A local file is memory-mapped, a file read through ``fs`` is
read whole; either way each tensor the loader keeps is copied out of it.

Name mapping (HF ``LlamaForCausalLM`` -> ``llama.init_params``'s tree): HF
stores ``model.layers.N.self_attn.q_proj.weight`` as ``[out, in]``; the port
computes ``x @ W`` with stacked ``[L, in, out]`` weights, so each projection
is transposed and stacked. HF's RoPE is rotate-half, the convention of
``ops/rope.py``, so no head permutation.

``fs`` takes any object with ``open(path, mode)`` (and optionally
``exists``), defaulting to the OS filesystem.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.models.llama import LlamaConfig

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # viewed as torch.bfloat16
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class SafetensorsFile:
    """Read one ``.safetensors`` file: ``names()``, ``tensor(name)``."""

    def __init__(self, data: Any) -> None:
        (header_len,) = struct.unpack("<Q", data[:8])
        header = json.loads(bytes(data[8 : 8 + header_len]).decode("utf-8"))
        self._meta = {k: v for k, v in header.items() if k != "__metadata__"}
        self._payload = memoryview(data)[8 + header_len :]

    @classmethod
    def open(cls, path: str, fs: Any = None) -> "SafetensorsFile":
        if fs is not None:
            with fs.open(path, "rb") as f:
                return cls(f.read())
        # a local file is mapped, not read: only the tensors a loader takes
        # are paged in
        import mmap

        with open(path, "rb") as f:
            mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return cls(mapped)

    def names(self) -> list[str]:
        return list(self._meta)

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor on the host, a read-only view of the file's bytes
        (copy it before writing to it)."""
        meta = self._meta[name]
        start, end = meta["data_offsets"]
        try:
            np_dtype = _DTYPES[meta["dtype"]]
        except KeyError:
            raise ValueError(f"unsupported safetensors dtype {meta['dtype']}") from None
        arr = np.frombuffer(self._payload[start:end], dtype=np_dtype).reshape(meta["shape"])
        t = _from_numpy(arr)
        return t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` of a read-only buffer view without its warning:
    the tensor shares the read-only memory, and the loaders copy out of it."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def _open_checkpoint(path: str, fs: Any = None) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory (one file or an index of
    shards) or of one ``.safetensors`` path, as host views."""

    def _exists(p: str) -> bool:
        if fs is not None and hasattr(fs, "exists"):
            return fs.exists(p)
        return os.path.exists(p)

    files: list[str]
    if path.endswith(".safetensors"):
        files = [path]
    else:
        index = os.path.join(path, "model.safetensors.index.json")
        single = os.path.join(path, "model.safetensors")
        if _exists(index):
            if fs is not None:
                with fs.open(index, "rb") as f:
                    idx = json.loads(f.read())
            else:
                with open(index) as f:
                    idx = json.load(f)
            shard_names = sorted(set(idx["weight_map"].values()))
            files = [os.path.join(path, s) for s in shard_names]
        elif _exists(single):
            files = [single]
        else:
            raise FileNotFoundError(f"no model.safetensors[.index.json] in {path}")
    tensors: dict[str, torch.Tensor] = {}
    for fpath in files:
        sf = SafetensorsFile.open(fpath, fs)
        for name in sf.names():
            tensors[name] = sf.tensor(name)
    return tensors


def read_json(path: str, fs: Any = None) -> dict:
    if fs is not None:
        with fs.open(path, "rb") as f:
            return json.loads(f.read())
    with open(path) as f:
        return json.load(f)


def config_from_hf(path: str, fs: Any = None, **overrides: Any) -> LlamaConfig:
    """A ``LlamaConfig`` from an HF ``config.json``."""
    hf = read_json(os.path.join(path, "config.json"), fs)
    kw: dict[str, Any] = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def to_leaf(x: torch.Tensor, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` cast to ``dtype`` (f32 to bf16 rounds to nearest even, as
    ``ml_dtypes`` does) as a fresh contiguous tensor on ``device``: a leaf
    never aliases the file's bytes, on the host either."""
    return x.to(dtype).contiguous().to(device, copy=True)


def load_llama_from_hf(
    path: str,
    *,
    cfg: LlamaConfig | None = None,
    fs: Any = None,
    dtype: torch.dtype | None = None,
    sharding: Any = None,
    device: str | torch.device | None = None,
) -> tuple[LlamaConfig, dict]:
    """Load an HF Llama checkpoint into ``llama.init_params``'s tree on
    ``device`` (the card by default): ``(cfg, params)``. Each leaf is
    built on the host (transposed, stacked, cast) and then copied to the
    device. ``sharding=`` places the tree on a mesh: one
    ``parallel.sharding.NamedSharding`` for every leaf or a tree of them
    (``rules.tree_shardings(mesh, params)``); each leaf is then this rank's
    slice, cut on the host before the copy, and a replicated placement
    (``P()``) the whole leaf."""
    if sharding is not None:
        from gofr_tpu_torch.parallel.sharding import local_index, placement_at
    dev = resolve_device(device)
    if cfg is None:
        cfg = config_from_hf(path, fs)
    dtype = dtype or cfg.dtype
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    raw = _open_checkpoint(path, fs)
    L = cfg.n_layers

    def t(name: str) -> torch.Tensor:
        if name not in raw:
            raise KeyError(f"tensor {name} missing from checkpoint (have {len(raw)})")
        return raw[name]

    def put(x: torch.Tensor, dt: torch.dtype, path: str) -> torch.Tensor:
        if sharding is not None:
            place = placement_at(sharding, path)
            x = x[local_index(tuple(x.shape), place.spec, place.mesh)]
        return to_leaf(x, dt, dev)

    def proj(layer_tpl: str, path: str) -> torch.Tensor:
        """Per-layer [out, in] projections stacked as [L, in, out]."""
        return put(torch.stack([t(layer_tpl.format(n)).T for n in range(L)]), dtype, path)

    def norms(layer_tpl: str, path: str) -> torch.Tensor:
        return put(torch.stack([t(layer_tpl.format(n)) for n in range(L)]), torch.float32, path)

    params: dict = {
        "embedding": put(t("model.embed_tokens.weight"), dtype, "embedding"),
        "layers": {
            "wq": proj("model.layers.{}.self_attn.q_proj.weight", "layers/wq"),
            "wk": proj("model.layers.{}.self_attn.k_proj.weight", "layers/wk"),
            "wv": proj("model.layers.{}.self_attn.v_proj.weight", "layers/wv"),
            "wo": proj("model.layers.{}.self_attn.o_proj.weight", "layers/wo"),
            "w_gate": proj("model.layers.{}.mlp.gate_proj.weight", "layers/w_gate"),
            "w_up": proj("model.layers.{}.mlp.up_proj.weight", "layers/w_up"),
            "w_down": proj("model.layers.{}.mlp.down_proj.weight", "layers/w_down"),
            "attn_norm": norms("model.layers.{}.input_layernorm.weight", "layers/attn_norm"),
            "mlp_norm": norms("model.layers.{}.post_attention_layernorm.weight",
                              "layers/mlp_norm"),
        },
        "final_norm": put(t("model.norm.weight"), torch.float32, "final_norm"),
    }
    if cfg.tie_embeddings:
        pass  # the logits reuse embedding.T
    elif "lm_head.weight" in raw:
        params["lm_head"] = put(t("lm_head.weight").T, dtype, "lm_head")
    else:  # a tied checkpoint under an untied config: materialize the head
        params["lm_head"] = put(t("model.embed_tokens.weight").T, dtype, "lm_head")
    return cfg, params
