"""gofr_tpu_torch: the PyTorch/CUDA port of gofr_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, with the same module names
(``ops/``, ``models/``, ``serving/``) and the same tensor layouts at every
public function. It imports ``torch`` and nothing of JAX or ``gofr_tpu``.
Every Pallas TPU kernel on its path is a hand-written CUDA kernel under
``csrc/`` (built by ``_build.py`` with ``nvcc`` for ``sm_90a`` at first
use); each has a plain PyTorch version beside it, which CPU tensors take.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from gofr_tpu_torch.errors import (
    CircuitBreakerError,
    ErrorDeadlineExceeded,
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorRequestEntityTooLarge,
    ErrorServiceUnavailable,
    ErrorStaleEpoch,
    ErrorTooManyRequests,
    HTTPError,
)
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.serving.engine import EngineConfig, GenerationResult, ServingEngine

__all__ = [
    "CircuitBreakerError", "EngineConfig", "ErrorDeadlineExceeded", "ErrorEntityNotFound",
    "ErrorInvalidParam", "ErrorRequestEntityTooLarge", "ErrorServiceUnavailable", "ErrorStaleEpoch",
    "ErrorTooManyRequests", "GenerationResult", "HTTPError",
    "LlamaConfig", "ServingEngine",
]
