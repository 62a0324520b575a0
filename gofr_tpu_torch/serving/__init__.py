"""Serving of the port: the engine, its device functions, the paged KV cache,
the multi-tenant plane (LoRA adapters and tenant classes) and the
self-healing plane (the supervisor and device telemetry)."""

from gofr_tpu_torch.serving.device_telemetry import DeviceTelemetry
from gofr_tpu_torch.serving.lora import AdapterRegistry, LoraAdapter, make_adapter
from gofr_tpu_torch.serving.supervisor import EngineSupervisor
from gofr_tpu_torch.serving.tenancy import TenantPolicy, TenantRegistry

__all__ = ["AdapterRegistry", "DeviceTelemetry", "EngineSupervisor", "LoraAdapter",
           "TenantPolicy", "TenantRegistry", "make_adapter"]
