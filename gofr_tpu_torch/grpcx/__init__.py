"""gRPC serving for the port (a copy of ``gofr_tpu/grpcx``; reference:
pkg/gofr/grpc.go + pkg/gofr/grpc/log.go) on a wire the port owns.

The reference rides ``grpcio`` and ``protobuf``; the card's machine has
neither, so the port carries its own: HTTP/2 with gRPC's framing
(``h2.py``), HPACK (``hpack.py``) and the protobuf wire format with message
classes from descriptor sets (``protowire.py``), all in Python. Above them
the reference's modules keep their names, classes and signatures: the
server with its recovery and observability around every handler, the
built-in health service (hand-framed grpc.health.v1) and the reflection
gate (``server.py``, ``reflection.py``), the typed-service runtime and its
code generator (``runtime.py``, ``codegen.py``), and the Inference service:
unary Generate/Embed/Echo and server-streaming GenerateStream, the
token-by-token decode path (``inference.py``).
"""

from gofr_tpu_torch.grpcx.h2 import BlockingChannel, Channel, RpcError, StatusCode
from gofr_tpu_torch.grpcx.inference import InferenceClient, InferenceService
from gofr_tpu_torch.grpcx.runtime import GofrGrpcService, GofrStream, ProtoRequest
from gofr_tpu_torch.grpcx.server import GRPCServer

__all__ = [
    "BlockingChannel",
    "Channel",
    "GRPCServer",
    "GofrGrpcService",
    "GofrStream",
    "InferenceClient",
    "InferenceService",
    "ProtoRequest",
    "RpcError",
    "StatusCode",
]
