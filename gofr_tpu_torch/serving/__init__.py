"""Serving of the port: the engine, its device functions, the paged KV cache,
the multi-tenant plane (LoRA adapters and tenant classes), the
self-healing plane (the supervisor and device telemetry), the
observability plane (the metrics catalog and the request timelines), the
HA plane (idempotent submits and resumable streams) and cross-replica KV
(the prefix index and the KV migrator)."""

from gofr_tpu_torch.serving.dedup import DedupRegistry, ReplayGap, ReplayStream
from gofr_tpu_torch.serving.device_telemetry import DeviceTelemetry
from gofr_tpu_torch.serving.lora import AdapterRegistry, LoraAdapter, make_adapter
from gofr_tpu_torch.serving.metrics_catalog import register_serving_metrics
from gofr_tpu_torch.serving.prefix_index import (
    KVMigrator,
    PrefixIndex,
    decode_entry,
    encode_entry,
    local_engine_fetcher,
    local_engine_store,
)
from gofr_tpu_torch.serving.supervisor import EngineSupervisor
from gofr_tpu_torch.serving.tenancy import TenantPolicy, TenantRegistry

__all__ = ["AdapterRegistry", "DedupRegistry", "DeviceTelemetry", "EngineSupervisor",
           "KVMigrator", "LoraAdapter", "PrefixIndex", "ReplayGap", "ReplayStream",
           "TenantPolicy", "TenantRegistry", "decode_entry", "encode_entry",
           "local_engine_fetcher", "local_engine_store", "make_adapter",
           "register_serving_metrics"]
