"""Device policy of the port: the card unless the caller asks for the CPU.

Entry points take ``device=None`` and run on ``cuda``; without a card they
raise instead of quietly computing on the host. ``device="cpu"`` is the
explicit opt-in the tests use, and on the CPU every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gofr_tpu_torch runs on an NVIDIA GPU and none is visible; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array without a host sync: on the card the copy goes
    through pinned memory and is enqueued on the current stream (PyTorch's
    pinned allocator keeps the staging block alive until the copy ran), so
    it never waits for blocks already in flight. On the CPU it is a copy
    the caller may keep while the host array changes."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()
