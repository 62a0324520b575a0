"""The ``tpu`` datasource on the CUDA card: ``ctx.tpu.execute(...)`` inside
ordinary handlers (the north star). Device discovery, a keyed cache of
executables captured as CUDA graphs, execution into fresh outputs, memory
readings into health and metrics, and the sick-device breaker, all behind
the provider pattern so the container wires it like any datasource. The
names stay the reference's (``TPUClient``, ``new_tpu``, ``tpu.execute``
spans, the ``app_tpu_*`` series), so a handler ports unchanged."""

from gofr_tpu_torch.datasource.tpu.client import TPUClient, TPUError, new_tpu

__all__ = ["TPUClient", "TPUError", "new_tpu"]
