"""Carry the JAX package's Llama params into the port.

``params_from_jax`` takes the params pytree as numpy arrays (what
``jax.device_get`` returns) and gives the port's dict of tensors with the
same keys and shapes. The stacked ``[L, ...]`` layer leaves stay stacked
(``models.llama.layer_params`` takes per-layer views). bf16 arrives as an
``ml_dtypes`` array, which numpy cannot name: it is detected by its dtype's
name and crosses as its 16-bit pattern, so ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch._device import resolve_device


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: dict, device: str | torch.device | None = None) -> dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (the card by default)."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        return tensor_from_numpy(node, dev)

    return walk(tree)
