"""gRPC service registration on the PyTorch port (reference:
examples/grpc-server). The Inference service ships Echo/Generate/Embed;
GRPC_PORT selects the listener (default 9000). Without an engine attached,
Echo answers and Generate is UNIMPLEMENTED, as on the reference.

Run it with ``python examples_torch/grpc-server/main.py``, then call it
with any gRPC client, e.g. the port's own::

    import asyncio
    from gofr_tpu_torch.grpcx import InferenceClient
    print(asyncio.run(InferenceClient("127.0.0.1:9000").echo({"ping": 1})))
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gofr_tpu_torch.app import App  # noqa: E402
from gofr_tpu_torch.grpcx import InferenceService  # noqa: E402


def build_app(config=None) -> App:
    app = App(config)
    app.register_grpc_service(InferenceService())
    app.get("/", lambda ctx: {"grpc": "enabled"})
    return app


if __name__ == "__main__":
    build_app().run()
