"""The port's serving entry point: continuous-batching Llama serving behind
``/generate`` (JSON + SSE streaming), ``/generate/cancel``, ``/v1/models``,
``/requestz`` and ``/kv/fetch``, with ``/metrics`` on the metrics port (the
counterpart of ``examples/serving-llama/main.py``).

Run::

    python -m gofr_tpu_torch.serve

Config (the app's ``EnvConfig``: ``./configs/.env`` layered under the
process environment, or ``GOFR_CONFIGS_DIR``):

- ``SERVE_MODEL``: ``llama3-8b`` (default; Llama-3-8B widths, 32 layers)
  or ``tiny`` (``LlamaConfig.tiny``, for the CPU). The weights are random,
  from a generator seeded with 0;
- ``SERVE_DEVICE``: ``cuda`` (default; raises when no card is visible) or
  ``cpu``;
- ``HTTP_HOST``, ``HTTP_PORT`` (8000), ``METRICS_PORT`` (2121),
  ``LOG_LEVEL``, ``SHUTDOWN_GRACE_PERIOD``;
- the engine's ``TPU_*`` knobs (``EngineConfig.from_config``: the dense
  bf16 slot cache and 256-token prefill chunks by default).

``SIGTERM`` or ``SIGINT`` drains the engine (in-flight generations finish
within ``TPU_DRAIN_DEADLINE_S``), closes the servers and exits 0.
"""

from __future__ import annotations

import sys
from typing import Any

import torch

from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.app import App
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.serving.device_telemetry import DeviceTelemetry
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
from gofr_tpu_torch.serving.handlers import register_generation_routes
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

MODELS = {"llama3-8b": llama.LlamaConfig.llama3_8b, "tiny": llama.LlamaConfig.tiny}


def build_app(config: Any = None) -> App:
    """An ``App`` serving one engine over random weights of the configured
    model, with the container's metrics, tracer and logger, the generation
    routes and device telemetry."""
    app = App(config)
    conf = app.container.config
    model = conf.get_or_default("SERVE_MODEL", "llama3-8b")
    if model not in MODELS:
        raise ValueError(f"SERVE_MODEL={model!r}: must be one of {sorted(MODELS)}")
    device = resolve_device(conf.get_or_default("SERVE_DEVICE", "cuda"))
    cfg = MODELS[model]()
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    engine = ServingEngine(
        cfg, params,
        EngineConfig.from_config(conf),
        ByteTokenizer(cfg.vocab_size),
        device=device,
        metrics=app.container.metrics_manager,
        tracer=app.container.tracer,
        logger=app.container.logger,
    )
    register_generation_routes(app, engine)
    # HBM and duty-cycle gauges, the card in /.well-known/health
    telemetry = DeviceTelemetry(engine, metrics=app.container.metrics_manager)
    app.on_start(lambda ctx: telemetry.start())
    app.on_shutdown(telemetry.stop)
    app.logger.info(f"serving {model} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
                    f"on {engine.device}")
    return app


def main() -> int:
    build_app().run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
