"""Serving of the port: the engine, its device functions, the paged KV cache,
the multi-tenant plane (LoRA adapters and tenant classes), the
self-healing plane (the supervisor and device telemetry), the
observability plane (the metrics catalog and the request timelines), the
HA plane (idempotent submits and resumable streams), cross-replica KV
(the prefix index and the KV migrator), and the fleet tier: membership
over heartbeats, the prefix-affine router with failover, hedging and P/D
routing over local or HTTP replicas, and the autoscaler with its pool
driver. The HTTP bindings are ``serving/handlers.py`` (the generation
routes, over HTTP and WebSocket, and /embed) and ``serving/remote.py`` (the
remote streaming client); ``serving/asr.py``'s ``ASRWorker`` serves Whisper
transcription behind a subscriber."""

from gofr_tpu_torch.serving.asr import ASRWorker
from gofr_tpu_torch.serving.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ReplicaPoolDriver,
    SimulatedPoolDriver,
    engine_factory,
    release_replica,
)
from gofr_tpu_torch.serving.dedup import DedupRegistry, ReplayGap, ReplayStream
from gofr_tpu_torch.serving.device_telemetry import DeviceTelemetry
from gofr_tpu_torch.serving.lora import AdapterRegistry, LoraAdapter, make_adapter
from gofr_tpu_torch.serving.membership import Heartbeat, MembershipTable, ReplicaAnnouncer
from gofr_tpu_torch.serving.metrics_catalog import register_serving_metrics
from gofr_tpu_torch.serving.prefix_index import (
    KVMigrator,
    PrefixIndex,
    decode_entry,
    encode_entry,
    local_engine_fetcher,
    local_engine_store,
)
from gofr_tpu_torch.serving.router import (
    HTTPReplica,
    LocalReplica,
    Router,
    RouterConfig,
    prefix_affinity_key,
)
from gofr_tpu_torch.serving.supervisor import EngineSupervisor
from gofr_tpu_torch.serving.tenancy import TenantPolicy, TenantRegistry
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, HFTokenizer, Tokenizer, pad_batch

__all__ = ["ASRWorker", "AdapterRegistry", "Autoscaler", "AutoscalerConfig",
           "ByteTokenizer", "DedupRegistry", "DeviceTelemetry", "EngineSupervisor",
           "HFTokenizer", "HTTPReplica", "Heartbeat", "KVMigrator", "LocalReplica",
           "LoraAdapter", "MembershipTable", "PrefixIndex", "ReplayGap", "ReplayStream",
           "ReplicaAnnouncer", "ReplicaPoolDriver", "Router", "RouterConfig",
           "SimulatedPoolDriver", "TenantPolicy", "TenantRegistry", "Tokenizer",
           "decode_entry", "encode_entry", "engine_factory", "local_engine_fetcher",
           "local_engine_store", "make_adapter", "pad_batch", "prefix_affinity_key",
           "register_serving_metrics", "release_replica"]
