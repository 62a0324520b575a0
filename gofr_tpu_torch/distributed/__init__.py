"""Cross-host coordination (a copy of ``gofr_tpu/distributed``):
leader/worker membership, heartbeat + health fan-in, dp-shard assignment —
over the framework's own typed gRPC (coordination.proto →
coordination_gofr.py via grpcx/codegen.py, on the port's own wire). It
coordinates processes; it touches no mesh and no collective, which stay with
``parallel/``."""

from gofr_tpu_torch.distributed.coordinator import ClusterState, CoordinationService, MemberInfo
from gofr_tpu_torch.distributed.worker import WorkerAgent

__all__ = ["ClusterState", "CoordinationService", "MemberInfo", "WorkerAgent"]
